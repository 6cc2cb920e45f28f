"""Record the JAX package's distributed results for tests/test_torch_dist.py.

    python scripts/make_dist_golden.py

Runs ``supersonic_tpu.parallel`` on a CPU mesh of 2 and of 4 devices over
the tables of ``tests/torch_dist_scenarios.py`` and writes the collected
rows (in the JAX package's shard-major order), each shard's partition,
the shuffle's ``sent_rows`` matrix and the overflow errors to
``tests/golden/dist_jax.json``.  The JAX package compiles each
distributed program in 5-60 s on the CPU (about 8 minutes in all), too
long for every test run, so the test holds the port against this record
and checks the cheap parts (partitions, a shuffle, an overflow) against
the JAX package live.
"""
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import supersonic_tpu as J  # noqa: E402
from supersonic_tpu.parallel import dist as D  # noqa: E402

import torch_dist_scenarios as S  # noqa: E402
from torch_dist_scenarios import raised  # noqa: E402

OUT = ROOT / "tests" / "golden" / "dist_jax.json"


def record(P):
    mesh = D.make_mesh(P)
    kw = {}

    def shards(dt):
        return S.shards(J, dt)
    fact, dim = S.fact_dim(J, kw)

    def rows(t):
        return D.collect_table(t).to_pylist()

    def dist(t, **k):
        return D.distribute_table(t, mesh, **k)

    rec = {}
    rec["partitions"] = {"round_robin": shards(dist(fact)),
                         "fk": shards(dist(fact, keys=["fk"]))}
    keyed = S.keyed_table(J, kw)
    for keys in (["a"], ["b"], ["c"], ["s"], ["a", "c", "s"]):
        rec["partitions"][",".join(keys)] = shards(dist(keyed, keys=keys))
    rec["group_aggregate"] = rows(D.dist_group_aggregate(
        mesh, dist(fact), ["fk"], S.specs(J, S.SUM_COUNT_MIN_MAX),
        out_cap_per_peer=256))
    for jt in ("INNER", "LEFT_OUTER"):
        rec[f"join_{jt}"] = rows(D.dist_hash_join(
            mesh, getattr(J.JoinType, jt), ["fk"], ["pk"], dist(fact),
            dist(dim), J.KeyUniqueness.UNIQUE, out_cap_per_peer=256))
        lhs, rhs = S.ring_sides(J, kw)
        rec[f"ring_{jt}"] = rows(D.dist_hash_join_ring(
            mesh, getattr(J.JoinType, jt), ["fk"], ["pk"], dist(lhs),
            dist(rhs, keys=["pk"])))
    lhs, rhs = S.outer_sides(J, kw)
    rec["left_outer"] = rows(D.dist_hash_join(
        mesh, J.JoinType.LEFT_OUTER, ["k"], ["k2"], dist(lhs), dist(rhs),
        J.KeyUniqueness.UNIQUE, out_cap_per_peer=32))
    lhs, rhs = S.skew_sides(J, kw)
    rec["skew"] = rows(D.dist_hash_join_skew(
        mesh, J.JoinType.INNER, ["fk"], ["pk"], dist(lhs), dist(rhs),
        J.KeyUniqueness.UNIQUE, out_cap_per_peer=512, hot_cap=64,
        min_frac=0.05))
    rec["sort_v"] = rows(D.dist_sort(mesh, dist(fact), ["v"],
                                     out_cap_per_peer=256))
    rec["sort_two_keys"] = rows(D.dist_sort(
        mesh, dist(keyed), [J.SortKey("c", ascending=False),
                            J.SortKey("s")]))
    small, _ = S.fact_dim(J, kw, n=64)
    rec["shuffle_mod"] = rows(D.shuffle(
        mesh, dist(small),
        lambda t: (t.columns["fk"].values % P).astype(np.int32), 64))
    stats = {}
    out = D.shuffle(mesh, dist(S.exchange_table(J, kw)),
                    D._key_dest_fn(["k"], P), stats_out=stats)
    rec["exchange"] = {"sent_rows": stats["sent_rows"].tolist(),
                       "rows": rows(out)}
    rec["overflow"] = raised(lambda: D.dist_group_aggregate(
        mesh, dist(S.hot_table(J, kw)), ["fk"],
        S.specs(J, (("SUM", "v", "sv"),), distinct=True),
        out_cap_per_peer=8))
    return rec


def main():
    golden = {str(P): record(P) for P in (2, 4)}
    OUT.write_text(json.dumps(golden, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
