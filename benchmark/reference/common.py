"""Plain PyTorch pieces of the references: an answer's form, a join by key,
a group-by by unique rows, and the word tests of STRING columns.

The references read the arrays that the data generator made (STRING
columns as codes into sorted word lists) and nothing that the program has
made.  They import neither JAX nor the program.  ``low`` selects the
control: the same query computed in the precision just below the one that
the configuration states (int32 sums that wrap for exact INT64 sums, float32
for DOUBLE).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Answer:
    """A query's rows: ``columns`` maps each output column, in output order,
    to a host array (STRING values as Python str).  ``keys`` identify a row,
    ``approx`` are compared by relative error, ``order`` is the ORDER BY as
    (column, ascending) pairs."""

    columns: dict
    keys: list = field(default_factory=list)
    approx: list = field(default_factory=list)
    order: list = field(default_factory=list)

    @property
    def rows(self) -> int:
        return len(next(iter(self.columns.values())))


@dataclass
class Data:
    """The generated data on the reference's device: ``tables[t][c]`` a
    tensor, ``words[t][c]`` the sorted words of a STRING column's codes."""

    tables: dict
    words: dict


def word_mask(data: Data, table: str, column: str, test) -> torch.Tensor:
    """bool over the codes of a STRING column: ``test(word)`` per word."""
    words = data.words[table][column]
    return torch.tensor([bool(test(w)) for w in words], dtype=torch.bool,
                        device=data.tables[table][column].device)


def lookup(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """For each probe key, the row of ``build_keys`` (unique) that holds it,
    or -1."""
    sk, perm = torch.sort(build_keys)
    pos = torch.searchsorted(sk, probe_keys).clamp_(max=sk.numel() - 1)
    return torch.where(sk[pos] == probe_keys, perm[pos],
                       torch.full_like(pos, -1))


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as an int32 accumulator would hold them."""
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def group_sum(keys: list, values: torch.Tensor, low: bool):
    """GROUP BY the key tensors (one row a kept fact row) with SUM(values):
    (unique key rows [G, k] on the host, int64 sums [G] on the host).  The
    sums are exact in int64, or wrapped to int32 under ``low``."""
    stacked = torch.stack([k.to(torch.int64) for k in keys], dim=1)
    uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64,
                       device=values.device)
    sums.index_add_(0, inv, values.to(torch.int64))
    if low:
        sums = wrap_int32(sums)
    return uniq.cpu().numpy(), sums.cpu().numpy()


def decode(data: Data, table: str, column: str, codes: np.ndarray):
    """Host values of a column from its codes: words for STRING columns,
    the integers themselves otherwise."""
    words = data.words.get(table, {}).get(column)
    if words is None:
        return np.asarray(codes, dtype=np.int64)
    out = np.empty(len(codes), dtype=object)
    out[:] = [words[int(c)] for c in codes]
    return out
