"""Pieces shared by the data generators."""
from __future__ import annotations

import torch


def order_lines(n: int, g: torch.Generator, device) -> torch.Tensor:
    """The order (0-based) of each of ``n`` lines: orders of 1-7 lines,
    uniform (TPC-H §4.2.3, which SSB's lineorder keeps), cut at ``n``
    lines."""
    n_orders = n // 4 + n // 20 + 100
    counts = torch.randint(1, 8, (n_orders,), generator=g, device=device)
    total = int(counts.sum())
    if total < n:
        raise RuntimeError("too few orders drawn for the line count")
    return torch.repeat_interleave(
        torch.arange(n_orders, device=device), counts,
        output_size=total)[:n]


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE x 100 (TPC-H §4.2.3) of int64 part keys."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
