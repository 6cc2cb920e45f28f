"""The port's spread and segment_reduce_small wrappers on the CPU, where
they run their plain PyTorch versions: against the JAX package's kernels
(interpret mode, as tests/test_spread_kernel.py and the segment-reduce
tests run them) and against numpy.  The CUDA kernels are held against the
same plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from supersonic_tpu.kernels import segment_reduce as jax_segment_reduce
from supersonic_tpu.kernels import spread as jax_spread
from supersonic_tpu_torch import kernels
from supersonic_tpu_torch.kernels.segment_reduce import (
    segment_reduce_small, segment_reduce_small_ref)
from supersonic_tpu_torch.kernels.spread import I32_MAX, spread_kernel

torch.set_num_threads(1)

_TILE = jax_spread.TILE


def _runs(rng, n_out, max_eff):
    """Run widths in [1, max_eff] until they cover n_out rows."""
    effs, total = [], 0
    while total < n_out:
        e = int(rng.integers(1, max_eff + 1))
        effs.append(e)
        total += e
    eff = np.array(effs)
    return eff, np.concatenate([[0], np.cumsum(eff)])[:-1].astype(np.int32)


@pytest.mark.parametrize("n_out,max_eff,seed", [
    (2 * _TILE, 1, 1),
    (_TILE + 5000, 3, 0),
    (40000, 1000, 4),
])
def test_spread_matches_jax_kernel(n_out, max_eff, seed):
    """Bit-exact on every live row against the Pallas kernel."""
    rng = np.random.default_rng(seed)
    eff, base = _runs(rng, n_out, max_eff)
    a = rng.integers(-2**31, 2**31 - 1, len(eff), dtype=np.int32)
    b = rng.standard_normal(len(eff)).astype(np.float32)
    want = jax_spread.spread_kernel([jnp.asarray(a), jnp.asarray(b)],
                                    jnp.asarray(base), n_out)
    got = spread_kernel([torch.from_numpy(a), torch.from_numpy(b)],
                        torch.from_numpy(base), n_out)
    live = min(int(eff.sum()), n_out)
    assert [g.shape[0] for g in got] == [n_out, n_out]
    np.testing.assert_array_equal(got[0].numpy()[:live],
                                  np.asarray(want[0])[:live])
    np.testing.assert_array_equal(got[1].numpy()[:live].view(np.int32),
                                  np.asarray(want[1])[:live].view(np.int32))
    np.testing.assert_array_equal(got[0].numpy()[:live],
                                  np.repeat(a, eff)[:live])


@pytest.mark.parametrize("cap_frac,dead", [(1.5, 0), (0.6, 0), (1.0, 37)])
def test_spread_widths_and_capacity_against_repeat(cap_frac, dead):
    """1- and 8-byte payloads move natively; rows past the total hold the
    last live source; out_cap below the total truncates; dead sources
    padded with the int32 maximum are never read."""
    rng = np.random.default_rng(9)
    eff, base = _runs(rng, 5000, 6)
    total = int(eff.sum())
    out_cap = int(total * cap_frac)
    n = len(eff)
    pays = [rng.random(n) < 0.5,                                  # bool
            rng.integers(-2**62, 2**62, n),                       # i64
            rng.standard_normal(n),                               # f64
            rng.integers(0, 200, n).astype(np.uint8)]             # u8
    base_p = np.concatenate([base, np.full(dead, I32_MAX, np.int32)])
    pays_p = [np.concatenate([p, np.zeros(dead, p.dtype)]) for p in pays]
    got = spread_kernel([torch.from_numpy(p) for p in pays_p],
                        torch.from_numpy(base_p), out_cap)
    idx = np.repeat(np.arange(n), eff)
    idx = np.concatenate([idx, np.full(max(out_cap - total, 0), n - 1)])
    for p, g in zip(pays, got):
        assert g.dtype == torch.from_numpy(p).dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      p[idx[:out_cap]].view(np.uint8))


def test_spread_edges():
    empty = torch.zeros(0, dtype=torch.int32)
    out = spread_kernel([torch.zeros(0, dtype=torch.float32)], empty, 5)
    assert out[0].tolist() == [0.0] * 5  # no source
    one = spread_kernel([torch.tensor([7], dtype=torch.int32)],
                        torch.tensor([0], dtype=torch.int32), 4)
    assert one[0].tolist() == [7, 7, 7, 7]
    with pytest.raises(ValueError):
        spread_kernel([torch.zeros(3)], torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        spread_kernel([torch.zeros(2)], torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        spread_kernel([torch.zeros(3)], torch.zeros(3, dtype=torch.int32),
                      2 ** 31)
    with pytest.raises(ValueError):  # the row add takes int32 payloads
        spread_kernel([torch.zeros(3)], torch.zeros(3, dtype=torch.int32), 4,
                      add_row=(0,))


@pytest.mark.parametrize("n_src,out_cap,offset", [
    (0, 5, 0),        # no source
    (5, 0, 0),        # no row to write
    (3001, 2049, 1),  # ragged: one output tile and one row
    (1500, 4097, 3),  # rows past the total hold the last source
])
def test_spread_views_and_edges_on_cpu(n_src, out_cap, offset):
    """Ragged lengths, no source, no row, and base and payloads that are
    views at odd offsets, against numpy; the CPU launches no kernel."""
    rng = np.random.default_rng(n_src + out_cap)
    eff = rng.integers(1, 4, n_src)
    base = np.concatenate([np.zeros(offset, np.int32),
                           (np.cumsum(eff) - eff).astype(np.int32)])
    pays = [rng.integers(-2**31, 2**31 - 1, n_src + offset, dtype=np.int32),
            rng.standard_normal(n_src + offset),
            rng.random(n_src + offset) < 0.5]
    kernels.reset_launches()
    got = spread_kernel([torch.from_numpy(p)[offset:] for p in pays],
                        torch.from_numpy(base)[offset:], out_cap, add_row=(0,))
    rows = np.arange(out_cap)
    src = np.clip(np.searchsorted(base[offset:], rows, side="right") - 1, 0,
                  None)
    for i, (p, g) in enumerate(zip(pays, got)):
        assert g.shape[0] == out_cap
        if n_src == 0:
            assert not g.any()
            continue
        want = p[offset:][src]
        if i == 0:
            want = (want.astype(np.int64) + rows).astype(np.int32)
        np.testing.assert_array_equal(g.numpy(), want)
    assert kernels.launches["spread"] == 0


def test_spread_adds_the_row_index_wrapping_like_int32():
    """The join's build position j + d comes out of the expansion."""
    d = torch.tensor([5, I32_MAX - 2, -7], dtype=torch.int32)
    v = torch.tensor([1.5, 2.5, 3.5])
    base = torch.tensor([0, 2, 4], dtype=torch.int32)
    bpos, vv = spread_kernel([d, v], base, 6, add_row=(0,))
    assert bpos.tolist() == [5, 6, I32_MAX, -2**31, -3, -2]
    assert vv.tolist() == [1.5, 1.5, 2.5, 2.5, 3.5, 3.5]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("mode", ["sum", "min", "max"])
def test_segment_reduce_small_matches_jax_kernel(mode, dtype):
    rng = np.random.default_rng(5)
    K = 300
    n = jax_segment_reduce.TILE + 777
    ids = rng.integers(-2, K + 4, n).astype(np.int32)  # some drop
    if dtype == np.int32:
        v = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)  # sums wrap
    else:
        v = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jax_segment_reduce.segment_reduce_small(
        jnp.asarray(v), jnp.asarray(ids), K, mode))
    got = segment_reduce_small(torch.from_numpy(v), torch.from_numpy(ids),
                               K, mode)
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == (K,)
    if dtype == np.float32 and mode == "sum":
        # f32 sums of ~30 normals per slot in another order: 1e-6
        # relative, and 1e-5 absolute for the sums near zero
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_segment_reduce_small_counts_its_own_launches():
    kernels.reset_launches()
    ids = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = segment_reduce_small(v, ids, 3, "max")
    assert got.tolist() == [1.0, 3.0, float("-inf")]
    assert torch.equal(got, segment_reduce_small_ref(v, ids, 3, "max"))
    assert set(kernels.launches.values()) == {0}  # CPU: no kernel
    with pytest.raises(ValueError):
        segment_reduce_small(v, ids, 3, "count")
