"""The port's distribution over ``torch.distributed``, held against the
JAX package's ``parallel`` on a CPU mesh of the same size.

One process group per world size (2 and 4 ranks over gloo, each rank a
spawned CPU process joined through ``multihost.initialize``) runs every
scenario of ``tests/torch_dist_scenarios.py`` once; the tests assert on
what the ranks handed back.  They mirror tests/test_parallel.py,
tests/test_exchange_bytes.py and tests/test_multihost.py one for one and
add what the port must share with the JAX package:
  * the same partition for every row (checked live against the JAX
    package, as are a shuffle's rows and ``sent_rows`` and the overflow
    error);
  * the same collected rows in the same order from the group-by, the
    joins, the ring and skew joins and the sort, against
    tests/golden/dist_jax.json, the JAX package's rows recorded by
    scripts/make_dist_golden.py on the same tables (its distributed
    programs compile for 5-60 s each on the CPU, too long for every run;
    ``test_golden_is_the_jax_package_output`` ties the record to the live
    package);
  * ``dist_sort`` globally ordered, and ``dryrun`` passing.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import supersonic_tpu_torch as T
from supersonic_tpu_torch import parallel as D

import torch_dist_scenarios as S

torch.set_num_threads(1)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "dist_jax.json").read_text())
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", params=[2, 4])
def P(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(P):
    """Every scenario's result on each rank, in rank order."""
    return D.spawn(P, S.run_all, (P,), device="cpu", threads=1)


@pytest.fixture(scope="module")
def jax_live(P):
    """The JAX package's partitions, one shuffle and one overflow, run now
    on a CPU mesh of P devices."""
    import supersonic_tpu as J
    from supersonic_tpu.parallel import dist as JD

    mesh = JD.make_mesh(P)
    fact, _ = S.fact_dim(J, {})
    keyed = S.keyed_table(J, {})
    parts = {"round_robin": S.shards(J, JD.distribute_table(fact, mesh)),
             "fk": S.shards(J, JD.distribute_table(fact, mesh, keys=["fk"]))}
    for keys in (["a"], ["b"], ["c"], ["s"], ["a", "c", "s"]):
        parts[",".join(keys)] = S.shards(J, 
            JD.distribute_table(keyed, mesh, keys=keys))
    stats = {}
    out = JD.shuffle(mesh, JD.distribute_table(S.exchange_table(J, {}), mesh),
                     JD._key_dest_fn(["k"], P), stats_out=stats)
    overflow = S.raised(lambda: JD.dist_group_aggregate(
        mesh, JD.distribute_table(S.hot_table(J, {}), mesh), ["fk"],
        S.specs(J, (("SUM", "v", "sv"),), distinct=True),
        out_cap_per_peer=8))
    return {"partitions": parts, "overflow": overflow,
            "exchange": {"sent_rows": stats["sent_rows"].tolist(),
                         "rows": JD.collect_table(out).to_pylist()}}


def rows(x):
    return [tuple(r) for r in x]


def golden(P, name):
    return rows(GOLDEN[str(P)][name])


def collected(ranks, name):
    """A scenario's collected rows, the same on every rank."""
    first = ranks[0][name]
    assert not (isinstance(first, tuple) and first[:1] == ("raised",)), first
    for r in ranks[1:]:
        assert r[name] == first
    return first


def local(plan):
    return T.execute(plan).to_pylist()


def by_str(x):
    return sorted(x, key=str)


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------

def test_distribute_collect_roundtrip(ranks, P, jax_live):
    fact, _ = S.fact_dim(T, CPU)
    rt = ranks[0]["roundtrip"]
    assert sorted(rt["collected"]) == sorted(fact.to_pylist())
    # every rank's partition is the JAX package's shard, row for row
    assert [r["roundtrip"]["local"] for r in ranks] == \
        [rows(s) for s in jax_live["partitions"]["round_robin"]]
    assert [r["roundtrip"]["local_keyed"] for r in ranks] == \
        [rows(s) for s in jax_live["partitions"]["fk"]]
    assert rt["cap"] == -(-200 // P) * 2


def test_partitions_match_jax(ranks, jax_live):
    """distribute_table by INT32, INT64, nullable INT64, STRING and
    composite keys puts every row in the JAX package's partition, in the
    same order (hash_of_pairs and partition_of agree bit for bit)."""
    for keys, shards in jax_live["partitions"].items():
        if keys in ("round_robin", "fk"):
            continue
        assert [r["partitions"][keys] for r in ranks] == \
            [rows(s) for s in shards], keys


def test_dist_group_aggregate_matches_local(ranks, P):
    fact, _ = S.fact_dim(T, CPU)
    got = collected(ranks, "group_aggregate")
    want = local(T.GroupAggregate(["fk"], S.specs(T, S.SUM_COUNT_MIN_MAX),
                                  T.ScanTable(fact)))
    assert sorted(got) == sorted(want)
    assert got == golden(P, "group_aggregate")


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_dist_hash_join_matches_local(ranks, P, jt):
    fact, dim = S.fact_dim(T, CPU)
    got = collected(ranks, f"join_{jt}")
    want = local(T.HashJoin(getattr(T.JoinType, jt), ["fk"], ["pk"],
                            T.ScanTable(fact), T.ScanTable(dim),
                            T.KeyUniqueness.UNIQUE))
    assert by_str(got) == by_str(want)
    assert got == golden(P, f"join_{jt}")


def test_dist_sort_globally_sorted(ranks, P):
    fact, _ = S.fact_dim(T, CPU)
    got = collected(ranks, "sort_v")
    want = local(T.Sort(["v"], T.ScanTable(fact)))
    # collect_table concatenates ranks in order => globally sorted
    assert [r[1] for r in got] == [r[1] for r in want]
    assert [r[1] for r in got] == sorted(r[1] for r in got)
    assert sorted(got) == sorted(want)
    assert got == golden(P, "sort_v")


def test_dist_sort_two_keys_in_order(ranks, P):
    """A DESC nullable key (NULLs last) then a STRING key: the global
    order of the reference comparator, and the JAX package's rows."""
    from supersonic_tpu_torch.reference import ref_engine as ref

    t = S.keyed_table(T, CPU)
    got = collected(ranks, "sort_two_keys")
    want = ref.sort_rows(t.to_pylist(), [(2, False), (3, True)])
    assert [(r[2], r[3]) for r in got] == [(r[2], r[3]) for r in want]
    assert sorted(got, key=str) == sorted(want, key=str)
    assert got == golden(P, "sort_two_keys")


def test_shuffle_preserves_rows(ranks, P):
    small, _ = S.fact_dim(T, CPU, n=64)
    got = collected(ranks, "shuffle_mod")
    assert sorted(got) == sorted(small.to_pylist())
    # every row went to rank fk % P, source-major within a rank
    assert got == golden(P, "shuffle_mod")


def test_left_outer_dist_join(ranks, P):
    lhs, rhs = S.outer_sides(T, CPU)
    got = collected(ranks, "left_outer")
    want = local(T.HashJoin(T.JoinType.LEFT_OUTER, ["k"], ["k2"],
                            T.ScanTable(lhs), T.ScanTable(rhs),
                            T.KeyUniqueness.UNIQUE))
    assert by_str(got) == by_str(want)
    assert got == golden(P, "left_outer")


def test_skew_aware_join_matches_local(ranks, P):
    lhs, rhs = S.skew_sides(T, CPU)
    got = collected(ranks, "skew")
    want = local(T.HashJoin(T.JoinType.INNER, ["fk"], ["pk"],
                            T.ScanTable(lhs), T.ScanTable(rhs),
                            T.KeyUniqueness.UNIQUE))
    assert sorted(got) == sorted(want)
    assert got == golden(P, "skew")


@pytest.mark.parametrize("jt", ["INNER", "LEFT_OUTER"])
def test_ring_pipelined_join_matches_local(ranks, P, jt):
    lhs, rhs = S.ring_sides(T, CPU)
    got = collected(ranks, f"ring_{jt}")
    want = local(T.HashJoin(getattr(T.JoinType, jt), ["fk"], ["pk"],
                            T.ScanTable(lhs), T.ScanTable(rhs),
                            T.KeyUniqueness.UNIQUE))
    assert by_str(got) == by_str(want)
    assert got == golden(P, f"ring_{jt}")


def _raised_everywhere(ranks, name):
    outs = [r[name] for r in ranks]
    assert all(o[:2] == ("raised", "EvaluationError") for o in outs), outs
    assert len({o[2] for o in outs}) == 1, outs
    return outs[0][2]


def test_skewed_exchange_overflow_raises(ranks, P, jax_live):
    """A deliberately skewed shuffle RAISES on every rank, with the JAX
    package's message (the same count of lost rows), rather than
    silently dropping rows."""
    msg = _raised_everywhere(ranks, "overflow")
    assert "exchange overflow" in msg
    assert ["EvaluationError", msg] == jax_live["overflow"] \
        == GOLDEN[str(P)]["overflow"]
    assert f"{S.N_HOT - P * 8} rows exceeded" in msg


def test_skewed_join_shuffle_overflow_raises(ranks):
    assert "exchange overflow" in _raised_everywhere(ranks, "join_overflow")


def test_skewed_exchange_default_caps_survive_hot_key(ranks):
    n = S.N_CAPS
    assert collected(ranks, "default_caps") == [(0, n * (n - 1) // 2)]


def test_dist_group_aggregate_quota_pregroup_stays_exact(ranks):
    small, _ = S.fact_dim(T, CPU, n=300, m=30)
    want = local(T.GroupAggregate(
        ["fk"], S.specs(T, (("SUM", "v", "sv"), ("COUNT", "v", "cv"))),
        T.ScanTable(small)))
    assert sorted(collected(ranks, "quota")) == sorted(want)


@pytest.mark.parametrize("jt", ["RIGHT_OUTER", "FULL_OUTER"])
def test_full_outer_dist_join(ranks, jt):
    lhs, rhs = S.full_outer_sides(T, CPU)
    want = local(T.HashJoin(getattr(T.JoinType, jt), ["k"], ["k2"],
                            T.ScanTable(lhs), T.ScanTable(rhs),
                            T.KeyUniqueness.UNIQUE))
    assert by_str(collected(ranks, f"full_outer_{jt}")) == by_str(want)


def test_dist_distinct_aggregate_matches_local(ranks):
    rng = np.random.default_rng(7)
    n = 500
    t = T.Table.from_data(
        T.TupleSchema.of(("g", T.DataType.INT64, False),
                         ("v", T.DataType.INT64, True)),
        {"g": rng.integers(0, 12, n),
         "v": [None if rng.random() < 0.1 else int(x)
               for x in rng.integers(0, 9, n)]}, **CPU)
    want = local(T.GroupAggregate(
        ["g"], S.specs(T, (("SUM", "v", "sv"), ("COUNT", "v", "cv")),
                       distinct=True), T.ScanTable(t)))
    assert sorted(collected(ranks, "distinct")) == sorted(want)


# ---------------------------------------------------------------------------
# tests/test_exchange_bytes.py
# ---------------------------------------------------------------------------

def test_shuffle_sent_matrix_matches_ground_truth(ranks, P, jax_live):
    t = S.exchange_table(T, CPU)
    res = [r["exchange"] for r in ranks]
    stats = res[0]["stats"]
    for r in res[1:]:
        np.testing.assert_array_equal(r["stats"]["sent_rows"],
                                      stats["sent_rows"])
    # ground truth: each rank's own destination counts of its live rows
    want = np.array([r["mine"] for r in res])
    np.testing.assert_array_equal(stats["sent_rows"], want)
    np.testing.assert_array_equal(stats["sent_rows"],
                                  jax_live["exchange"]["sent_rows"])
    assert stats["sent_rows"].sum() == int(t.num_rows)
    assert stats["row_bytes"] == D.table_row_bytes(t.schema) == 8
    assert stats["total_bytes"] == int(t.num_rows) * 8
    assert stats["offmesh_bytes"] == (want.sum() - np.trace(want)) * 8
    got = res[0]["collected"]
    assert sorted(got) == sorted(t.to_pylist())
    assert got == rows(jax_live["exchange"]["rows"])


def test_offmesh_share_tracks_uniform_model(ranks, P):
    """A uniform key hash sends ~ (P-1)/P of live rows off-rank."""
    stats = ranks[0]["exchange_uniform"]["stats"]
    model = 20000 * (P - 1) / P * stats["row_bytes"]
    assert abs(stats["offmesh_bytes"] - model) / model < 0.10


# ---------------------------------------------------------------------------
# tests/test_multihost.py, the deferred check, failures, dryrun, hashes
# ---------------------------------------------------------------------------

def test_two_process_distributed_aggregate(ranks, P):
    """Each rank joined through multihost.initialize (gloo over
    localhost); a group-by over the global mesh gives every rank the same
    checksum, equal to the host's."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 10, 256)
    v = rng.integers(0, 100, 256)
    want = {}
    for gi, vi in zip(g, v):
        want[int(gi)] = want.get(int(gi), 0) + int(vi)
    outs = [r["multihost"] for r in ranks]
    assert all(o == outs[0] for o in outs)
    assert outs[0] == {"multihost": True, "groups": len(want),
                       "checksum": sum(k * s for k, s in want.items())}


def test_deferred_overflow_check_raises(ranks):
    """shuffle(check=False) hands back the all-reduced dropped count;
    check_exchange_overflow raises on it."""
    msg = _raised_everywhere(ranks, "deferred_check")
    assert "exchange overflow" in msg


def test_a_failing_shard_fails_every_rank(ranks):
    """A signaling division by zero on one rank's rows raises the shard
    error on every rank, so no rank waits in a later collective."""
    assert _raised_everywhere(ranks, "shard_error") == \
        "evaluation failed on a shard: division by zero"


def test_dryrun_passes(ranks):
    assert all(r["dryrun"] is True for r in ranks), \
        [r["dryrun"] for r in ranks]


def test_golden_is_the_jax_package_output(P, jax_live):
    """The record the order checks use equals the JAX package's output
    wherever the test also runs the package live."""
    g = GOLDEN[str(P)]
    assert g["partitions"] == json.loads(json.dumps(jax_live["partitions"]))
    assert g["exchange"] == json.loads(json.dumps(jax_live["exchange"]))
    assert g["overflow"] == jax_live["overflow"]


def test_hashes_and_partitions_bit_equal_jax():
    """hash_of_pairs and partition_of over group_code_columns of INT32,
    INT64, nullable INT64 and STRING keys equal the JAX package's."""
    import supersonic_tpu as J
    from supersonic_tpu.ops.keys import group_code_columns as j_codes
    from supersonic_tpu.parallel import hashing as JH

    from supersonic_tpu_torch.ops.keys import group_code_columns as t_codes

    jt, tt = S.keyed_table(J, {}), S.keyed_table(T, CPU)
    for keys in (["a"], ["b"], ["c"], ["s"], ["a", "c", "s"], ["b", "s"]):
        jh = np.asarray(JH.hash_of_pairs(j_codes(jt, keys))).view(np.int32)
        th = D.hash_of_pairs(t_codes(tt, keys))
        np.testing.assert_array_equal(th.numpy(), jh, err_msg=str(keys))
        for parts in (2, 3, 4, 8):
            np.testing.assert_array_equal(
                D.partition_of(th, parts).numpy(),
                np.asarray(JH.partition_of(jh.view(np.uint32), parts)))
