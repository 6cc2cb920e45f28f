"""The port's kernel modules on the CPU: each plain PyTorch version (what a
wrapper runs for CPU tensors) against the JAX package's kernel function,
run in interpret mode as tests/test_compaction_kernel.py runs it.  The CUDA
kernels themselves are checked against these plain versions on the card
by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from supersonic_tpu.kernels import compaction as jax_compaction
from supersonic_tpu.kernels import lut_gather as jax_lut_gather
from supersonic_tpu.kernels import segment_reduce as jax_segment_reduce
from supersonic_tpu_torch import kernels
from supersonic_tpu_torch.kernels.compaction import (TILE_ROWS,
                                                     compact_arrays_ref,
                                                     compact_kernel,
                                                     kernel_launches,
                                                     scratch_words,
                                                     vector_loads)
from supersonic_tpu_torch.kernels.lut_gather import lut_gather
from supersonic_tpu_torch.kernels.merge_sorted import MergeKey, merge_sorted
from supersonic_tpu_torch.kernels.segment_reduce import segment_reduce_multi
from supersonic_tpu_torch.kernels.spread import spread_kernel

torch.set_num_threads(1)

_TILE = jax_compaction.TILE


@pytest.mark.parametrize("n,sel,cap_frac", [
    (2 * _TILE + 5000, 0.5, 1.0),   # two tiles and a ragged tail
    (2 * _TILE + 5000, 0.6, 0.25),  # out_cap below the kept count
    (1000, 0.0, 1.0),
    (3000, 1.0, 1.0),
])
def test_compaction_matches_jax_kernel(n, sel, cap_frac):
    rng = np.random.default_rng(n + int(sel * 10))
    m = rng.random(n) < sel
    x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    y = rng.random(n).astype(np.float32)
    out_cap = max(1, int(n * cap_frac))
    (jx, jy), jcnt = jax_compaction.compact_kernel(
        [jnp.asarray(x), jnp.asarray(y)], jnp.asarray(m), out_cap)
    (tx, ty), tcnt = compact_kernel(
        [torch.from_numpy(x), torch.from_numpy(y)], torch.from_numpy(m),
        out_cap)
    cnt = int(jcnt)
    assert int(tcnt) == cnt == min(int(m.sum()), out_cap)
    assert tx.shape[0] == ty.shape[0] == out_cap
    np.testing.assert_array_equal(tx[:cnt].numpy(), np.asarray(jx)[:cnt])
    np.testing.assert_array_equal(ty[:cnt].numpy().view(np.int32),
                                  np.asarray(jy)[:cnt].view(np.int32))


def test_compaction_moves_every_width_bit_exactly():
    rng = np.random.default_rng(3)
    n = 5003
    m = torch.from_numpy(rng.random(n) < 0.4)
    pays = [torch.from_numpy(rng.standard_normal(n)),            # f64
            torch.from_numpy(rng.integers(-2**62, 2**62, n)),    # i64
            torch.from_numpy(rng.random(n) < 0.5),               # bool
            torch.from_numpy(rng.integers(0, 9, n).astype(np.int16))]
    pays[0][7] = float("nan")
    pays[0][8] = -0.0
    outs, cnt = compact_arrays_ref(pays, m, n)
    keep = m.numpy()
    for p, o in zip(pays, outs):
        want = p.numpy()[keep]
        assert o.dtype == p.dtype
        np.testing.assert_array_equal(o[:int(cnt)].numpy().view(np.uint8),
                                      want.view(np.uint8))


@pytest.mark.parametrize("n,out_cap,words,launched", [
    (0, 5, 1, 0),                       # no row: no launch
    (1, 0, 2, 0),                       # nothing can be kept: no launch
    (TILE_ROWS - 1, 7, 2, 1),
    (TILE_ROWS, 7, 2, 1),
    (TILE_ROWS + 1, 7, 3, 1),           # a ragged second tile
    (2**16 * TILE_ROWS + 5, 1, 2**16 + 2, 1),
])
def test_compaction_scratch_and_launches(n, out_cap, words, launched):
    """One status word a tile and the tile counter; one launch a call."""
    assert scratch_words(n) == words
    assert kernel_launches(n, out_cap) == launched


def test_compaction_vector_route_follows_alignment():
    """16-byte loads only when the mask and every payload start on a
    16-byte boundary; a view at another offset takes element loads."""
    mask = torch.zeros(256, dtype=torch.bool)
    pay = torch.zeros(256, dtype=torch.int32)
    wide = torch.zeros(256, dtype=torch.float64)
    assert vector_loads([mask, pay, wide])
    assert vector_loads([mask[16:], pay[4:], wide[2:]])
    assert not vector_loads([mask[1:], pay[:255], wide[:255]])
    assert not vector_loads([mask[:255], pay[1:], wide[:255]])
    assert not vector_loads([mask[:255], pay[:255], wide[1:]])


@pytest.mark.parametrize("n,offset,out_cap", [
    (0, 0, 4),
    (777, 1, 0),
    (TILE_ROWS + 1, 3, TILE_ROWS),
    (2 * TILE_ROWS - 1, 5, 100),
])
def test_compaction_views_and_edges_on_cpu(n, offset, out_cap):
    """Ragged lengths, no row, no room, and a mask and payloads that are
    views at odd offsets, against numpy; the CPU launches no kernel."""
    rng = np.random.default_rng(n + offset)
    m = rng.random(n + offset) < 0.5
    pays = [rng.integers(-2**62, 2**62, n + offset),
            rng.random(n + offset).astype(np.float32),
            rng.integers(0, 9, n + offset).astype(np.int16)]
    kernels.reset_launches()
    got, cnt = compact_kernel([torch.from_numpy(p)[offset:] for p in pays],
                              torch.from_numpy(m)[offset:], out_cap)
    keep = m[offset:]
    c = min(int(keep.sum()), out_cap)
    assert int(cnt) == c
    for p, g in zip(pays, got):
        assert g.shape[0] == out_cap
        np.testing.assert_array_equal(g[:c].numpy(), p[offset:][keep][:c])
    assert kernels.launches["compaction"] == 0


def test_compaction_rejects_bad_inputs():
    with pytest.raises(ValueError):
        compact_kernel([torch.zeros(4)], torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        compact_kernel([torch.zeros(3)], torch.zeros(4, dtype=torch.bool), 4)
    with pytest.raises(ValueError):  # one launch moves at most 32 arrays
        compact_kernel([torch.zeros(4)] * (kernels.MAX_ARRAYS + 1),
                       torch.zeros(4, dtype=torch.bool), 4)


@pytest.mark.parametrize("K,offset", [
    pytest.param(300, 0, id="300"),
    pytest.param(4096, 0, id="4096"),
    pytest.param(777, 1, id="777-index-slice-at-odd-offset"),
])
def test_lut_gather_matches_jax_kernel(K, offset):
    rng = np.random.default_rng(K)
    n = 2 * jax_lut_gather.TILE + 77
    # out of range both ways; the port takes it as a slice at `offset`
    full = rng.integers(-3, K + 5, n + offset).astype(np.int32)
    idx = full[offset:]
    a = rng.integers(-2**31, 2**31 - 1, K, dtype=np.int32)
    b = rng.standard_normal(K).astype(np.float32)
    ja, jb = jax_lut_gather.lut_gather(
        [jnp.asarray(a), jnp.asarray(b).view(jnp.uint32)], jnp.asarray(idx), K)
    ta, tb = lut_gather([torch.from_numpy(a), torch.from_numpy(b)],
                        torch.from_numpy(full)[offset:], K)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))


def test_lut_gather_lanes_of_every_width():
    K = 50
    luts = [torch.arange(K, dtype=torch.float64) / 3,
            torch.arange(K) % 2 == 0,
            torch.arange(K, dtype=torch.int64) * (1 << 40)]
    idx = torch.tensor([-1, 0, 49, 50, 7], dtype=torch.int32)
    got = lut_gather(luts, idx, K)
    safe = torch.tensor([0, 0, 49, 49, 7])
    for lut, g in zip(luts, got):
        assert torch.equal(g, lut[safe])
    assert [g.dtype for g in got] == [t.dtype for t in luts]
    with pytest.raises(ValueError):
        lut_gather(luts, idx.long(), K)
    with pytest.raises(ValueError):  # one launch moves at most 32 lanes
        lut_gather(luts * 11, idx, K)


def _requests(rng, n):
    ivals = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)  # sums wrap
    fvals = rng.standard_normal(n).astype(np.float32)
    live = (rng.random(n) < 0.8).astype(np.int32)
    pos = np.where(live > 0, np.arange(n, dtype=np.int32), 2**31 - 1)
    return [(live, "count"), (fvals, "sum"), (ivals, "sum"), (ivals, "min"),
            (ivals, "max"), (fvals, "min"), (fvals, "max"),
            (pos.astype(np.int32), "firstpos")]


@pytest.mark.parametrize("K", [64, 300])
def test_segment_reduce_matches_jax_kernel(K):
    rng = np.random.default_rng(K)
    n = 2 * jax_segment_reduce.TILE + 123
    ids = rng.integers(-1, K + 3, n).astype(np.int32)  # ids -1 and >= K drop
    reqs = _requests(rng, n)
    want = jax_segment_reduce.segment_reduce_multi(
        [(jnp.asarray(v), m) for v, m in reqs], jnp.asarray(ids), K)
    got = segment_reduce_multi([(torch.from_numpy(v), m) for v, m in reqs],
                               torch.from_numpy(ids), K)
    assert got[0].dtype == torch.int64  # counts are exact int64
    for (v, mode), g, w in zip(reqs, got, want):
        w = np.asarray(w)
        if mode == "sum" and v.dtype == np.float32:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))


def test_segment_reduce_empty_slots_keep_init_values():
    ids = torch.tensor([0, 0, 2, -1], dtype=torch.int32)
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    i = torch.tensor([5, -7, 9, 1], dtype=torch.int32)
    s, mn, mx, c = segment_reduce_multi(
        [(v, "sum"), (i, "min"), (i, "max"), (torch.ones(4, dtype=torch.int32),
                                              "count")], ids, 4)
    assert s.tolist() == [3.0, 0.0, 3.0, 0.0]
    assert mn.tolist() == [-7, 2**31 - 1, 9, 2**31 - 1]
    assert mx.tolist() == [5, -2**31, 9, -2**31]
    assert c.tolist() == [2, 0, 1, 0]
    with pytest.raises(ValueError):
        segment_reduce_multi([(v, "sum")], ids, 4096)


def test_cpu_wrappers_launch_no_kernel():
    kernels.reset_launches()
    m = torch.ones(8, dtype=torch.bool)
    compact_kernel([torch.arange(8)], m, 8)
    lut_gather([torch.arange(8)], torch.zeros(8, dtype=torch.int32), 8)
    segment_reduce_multi([(torch.ones(8), "sum")],
                         torch.zeros(8, dtype=torch.int32), 2)
    spread_kernel([torch.arange(8)], torch.arange(8, dtype=torch.int32), 9)
    k = torch.arange(8, dtype=torch.int32)
    merge_sorted([k, k.double()], [k, k.double()], [MergeKey(1, False)], 16)
    assert kernels.launches == {"compaction": 0, "lut_gather": 0,
                                "segment_reduce": 0,
                                "segment_reduce_small": 0, "spread": 0,
                                "merge_sorted": 0}
