"""supersonic_tpu_torch: the PyTorch and CUDA port of supersonic_tpu.

A second package beside the JAX one, for an NVIDIA H100.  It imports torch
and numpy, never JAX and nothing of ``supersonic_tpu``, and mirrors that
package's public names for what it covers, so one plan-building function
can take either package as a namespace.  Its kernels are written by hand in
CUDA C++ (``csrc/``) and built at their first launch on a CUDA tensor; on
CPU tensors every kernel wrapper runs its plain PyTorch version.  See
ROADMAP.md for what is ported and what is still to come.
"""
from .types import (BINARY, BOOL, DATE, DATETIME, DOUBLE, ENUM, FLOAT, INT32,
                    INT64, STRING, UINT32, UINT64, DataType, TypeError_)
from .schema import Attribute, EnumDefinition, SchemaError, TupleSchema
from .batch import Column, Table, concat_tables, gather_table
from .dictionary import Dictionary
from . import exprs
from .exprs import *  # noqa: F401,F403 (expression factory surface)
from .ops import *    # noqa: F401,F403 (operator surface)

__version__ = "0.1.0"
