"""The one general generator of query streams.  It reads a traffic file:

    {"schema": "ssb",
     "queries": [{"query": "ssb_q2_1", "params": {"category": "MFGR#12"}},
                 {"query": "tpch_q1", "params": {"delta": {"int": [60, 120]}}}],
     "limits": {"wrong_answers": 0, "max_rel_err": 1e-10}}

The stream is made of rounds: each holds every query of the list once, in
an order drawn from the seed.  A parameter is a literal, or
``{"int": [lo, hi]}`` (a whole number drawn uniformly from lo to hi, both
included), or ``{"choice": [...]}`` (one of the values).  The same seed gives
the same stream; every seed gives each round the same queries, so the work
of a round does not depend on the seed.  ``limits`` are the numbers that
decide ``correct`` (``benchlib.compare``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Instance:
    """One query to run: its name, drawn parameters, and the key under
    which its answer is cached (equal for equal query and parameters)."""

    query: str
    params: dict
    key: tuple


def _draw(spec, rng: random.Random):
    if isinstance(spec, dict) and "int" in spec:
        lo, hi = spec["int"]
        return rng.randint(lo, hi)
    if isinstance(spec, dict) and "choice" in spec:
        return rng.choice(spec["choice"])
    return spec


def stream(traffic: dict, seed: int):
    """An endless iterator of ``Instance``s drawn from ``seed``."""
    rng = random.Random(f"traffic-{seed}")
    entries = traffic["queries"]
    while True:
        order = list(range(len(entries)))
        rng.shuffle(order)
        for i in order:
            q = entries[i]
            params = {k: _draw(v, rng)
                      for k, v in sorted(q.get("params", {}).items())}
            yield Instance(q["query"], params,
                           (q["query"],) + tuple(sorted(params.items())))
