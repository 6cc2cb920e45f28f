"""TupleSchema / Attribute (reference: base/infrastructure/tuple_schema.h:42-508).

A schema is an ordered list of named, typed, nullability-tagged attributes.
Unlike the reference (which interns schemas into refcounted C++ objects),
schemas here are lightweight immutable Python values used at *plan/bind
time* only — they never reach the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from .types import DataType


class SchemaError(Exception):
    """Bind-time schema error (reference: ERROR_ATTRIBUTE_MISSING etc.)."""


@dataclass(frozen=True)
class EnumDefinition:
    """Value map for ENUM columns (reference: tuple_schema.h:42)."""

    names: tuple[str, ...]  # index == stored int32 code

    def name_of(self, code: int) -> str:
        return self.names[code]

    def code_of(self, name: str) -> int:
        return self.names.index(name)


@dataclass(frozen=True)
class Attribute:
    """One column descriptor (reference: tuple_schema.h:77)."""

    name: str
    type: DataType
    nullable: bool = True
    enum: Optional[EnumDefinition] = None

    def __post_init__(self):
        if self.type == DataType.ENUM and self.enum is None:
            raise SchemaError(f"ENUM attribute {self.name!r} needs an EnumDefinition")

    @property
    def is_nullable(self) -> bool:
        return self.nullable


class TupleSchema:
    """Ordered attribute list with name lookup (reference: tuple_schema.h:126)."""

    __slots__ = ("_attrs", "_index")

    def __init__(self, attrs: Sequence[Attribute] = ()):
        self._attrs: tuple[Attribute, ...] = tuple(attrs)
        self._index: dict[str, int] = {}
        for i, a in enumerate(self._attrs):
            if a.name in self._index:
                raise SchemaError(f"duplicate attribute name {a.name!r}")
            self._index[a.name] = i

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def of(*cols: tuple) -> "TupleSchema":
        """TupleSchema.of(("a", INT64), ("b", DOUBLE, False)) — trailing bool
        is nullability (default True)."""
        attrs = []
        for c in cols:
            if isinstance(c, Attribute):
                attrs.append(c)
            else:
                name, typ, *rest = c
                nullable = rest[0] if rest else True
                enum = rest[1] if len(rest) > 1 else None
                attrs.append(Attribute(name, typ, nullable, enum))
        return TupleSchema(attrs)

    def concat(self, other: "TupleSchema") -> "TupleSchema":
        """Schema merge; rejects duplicate names (reference: tuple_schema.h
        TryMerge)."""
        return TupleSchema(self._attrs + other._attrs)

    def rename(self, mapping: dict[str, str]) -> "TupleSchema":
        return TupleSchema(
            tuple(
                Attribute(mapping.get(a.name, a.name), a.type, a.nullable, a.enum)
                for a in self._attrs
            )
        )

    # -- access ---------------------------------------------------------------
    def attribute_count(self) -> int:
        return len(self._attrs)

    def __len__(self) -> int:
        return len(self._attrs)

    def __iter__(self) -> Iterator[Attribute]:
        return iter(self._attrs)

    def attribute(self, position: int) -> Attribute:
        return self._attrs[position]

    def names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self._attrs)

    def lookup_position(self, name: str) -> int:
        if name not in self._index:
            raise SchemaError(
                f"attribute {name!r} missing; have {list(self._index)}"
            )
        return self._index[name]

    def lookup(self, name: str) -> Attribute:
        return self._attrs[self.lookup_position(name)]

    def has(self, name: str) -> bool:
        return name in self._index

    def __eq__(self, other) -> bool:
        return isinstance(other, TupleSchema) and self._attrs == other._attrs

    def __hash__(self) -> int:
        return hash(self._attrs)

    def __repr__(self) -> str:  # human-readable spec, reference: tuple_schema
        cols = ", ".join(
            f"{a.name}: {a.type.value}{'' if a.nullable else ' NOT NULL'}"
            for a in self._attrs
        )
        return f"TupleSchema({cols})"
