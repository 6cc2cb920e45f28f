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
from supersonic_tpu_torch.kernels.segment_reduce import (
    per_thread_accumulators, segment_reduce_keyed, segment_reduce_multi)
from supersonic_tpu_torch.kernels.segment_reduce import \
    vector_loads as seg_vector_loads
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


_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _signed_zeros_and_nans(rng, x):
    """f32 x with its zeros' signs and a few NaNs of both signs set by
    their bits."""
    bits = x.view(np.int32).copy()
    zero = (bits & 0x7FFFFFFF) == 0
    bits[zero] = np.where(rng.random(int(zero.sum())) < 0.5, _I32_MIN, 0)
    at = rng.choice(x.shape[0], 12, replace=False)
    bits[at[:6]] = 0x7FC00000     # +NaN
    bits[at[6:]] = -0x00400000    # -NaN (0xFFC00000)
    return bits.view(np.float32)


def _jax_ids(keys, keep, num_rows):
    """(ids, live, dropped live rows) computed in numpy as
    supersonic_tpu/ops/aggregate.py:504-519 does: int32 key lanes in int32,
    int64 lanes in int64, each dimension clipped into the mixed radix."""
    n = keys[0][0].shape[0]
    live = np.ones(n, bool) if keep is None else keep.copy()
    if num_rows is not None:
        live &= np.arange(n) < num_rows
    gid, dom = None, None
    for lane, kmin, k_i in keys:
        v = (lane - lane.dtype.type(kmin)).astype(np.int64)
        ok = (v >= 0) & (v < k_i)
        vc = np.clip(v, 0, k_i - 1)
        gid = vc if gid is None else gid * k_i + vc
        dom = ok if dom is None else dom & ok
    bad = int((live & ~dom).sum())
    live &= dom
    return np.where(live, gid, -1).astype(np.int32), live, bad


def _jax_requests(reqs, live, n):
    """The keyed requests as the JAX aggregate hands them to its kernel."""
    out = []
    pos = np.arange(n, dtype=np.int32)
    for values, valid, mode in reqs:
        ok = live if valid is None else live & valid
        if mode == "count":
            x = ok.astype(np.int32) if values is None else np.where(
                ok, values, 0).astype(np.int32)
        elif mode == "sum":
            x = np.where(ok, values, 0).astype(values.dtype)
        else:
            vals = pos if values is None else values
            lo = mode in ("min", "firstpos")
            if vals.dtype == np.float32:
                vals = np.where(vals == 0, np.float32(0), vals)  # keys.py
                init = np.float32(np.inf if lo else -np.inf)
            else:
                init = np.int32(_I32_MAX if lo else _I32_MIN)
            x = np.where(ok, vals, init).astype(vals.dtype)
            mode = "firstpos" if mode == "firstpos" else (
                "min" if lo else "max")
        out.append((x, mode))
    return out


@pytest.mark.parametrize("case", ["int32", "int64", "int32_int64",
                                  "int64_int32_rows"])
def test_segment_reduce_keyed_matches_jax_kernel(case):
    """The keyed form against the JAX kernel given the ids the JAX
    aggregate computes: INT32 and INT64 keys, one and two dimensions,
    kmin != 0, kept rows outside the domain (counted), a keep mask, a row
    count, nullable inputs, NaNs of both signs and +-0 (min and max give
    NaN to every group holding a NaN, as the JAX kernel does)."""
    rng = np.random.default_rng(len(case))
    n = jax_segment_reduce.TILE - 1000  # one tile of the JAX kernel
    big = 5_000_000_000
    if case == "int32":
        keys = [(rng.integers(-9, 33, n).astype(np.int32), -7, 38)]
    elif case == "int64":
        keys = [(rng.integers(big - 2, big + 45, n), big, 43)]
    elif case == "int32_int64":
        keys = [(rng.integers(99, 112, n).astype(np.int32), 100, 11),
                (rng.integers(-8, 2, n), -7, 9)]
    else:
        keys = [(rng.integers(big, big + 7, n), big, 7),
                (rng.integers(-20, 21, n).astype(np.int32), -20, 40)]
    K = int(np.prod([k for _, _, k in keys]))
    keep = rng.random(n) < 0.8
    num_rows = n - 777 if case.endswith("rows") else None
    valid = rng.random(n) < 0.85
    base = np.round(rng.standard_normal(n) * 2) / 2
    fv = _signed_zeros_and_nans(rng, base.astype(np.float32))
    iv = rng.integers(-1000, 1000, n).astype(np.int32)
    reqs = [(None, None, "count"), (None, valid, "count"),
            ((iv > 0).astype(np.int32), None, "count"),
            (rng.random(n).astype(np.float32), valid, "sum"),
            (fv, None, "sum"), (iv, valid, "sum"), (iv, None, "min"),
            (iv, valid, "max"), (fv, valid, "min"), (fv, None, "max"),
            (None, None, "firstpos"), (None, valid, "lastpos")]
    nan_sum = 4  # (fv, None, "sum"): held against numpy, see below
    ids, live, bad = _jax_ids(keys, keep, num_rows)
    assert bad > 0
    want = jax_segment_reduce.segment_reduce_multi(
        [(jnp.asarray(x), m) for x, m in _jax_requests(reqs, live, n)],
        jnp.asarray(ids), K)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got, got_bad = segment_reduce_keyed(
        [(t(lane), kmin, k_i) for lane, kmin, k_i in keys],
        [(t(v), t(d), m) for v, d, m in reqs], K, keep=t(keep),
        num_rows=num_rows)
    assert int(got_bad) == bad
    assert got[0].dtype == torch.int64  # counts are exact int64
    for q, ((v, _, mode), g, w) in enumerate(zip(reqs, got, want)):
        g, w = g.numpy(), np.asarray(w).astype(g.numpy().dtype)
        if q == nan_sum:
            # the JAX kernel adds f32 sums as one-hot MXU dots, where a NaN
            # row (times 0) makes every slot NaN; the port, like the C++
            # reference, gives NaN only to the groups that hold one
            assert np.isnan(w).all()
            w64 = np.zeros(K)
            np.add.at(w64, ids[ids >= 0], v[ids >= 0].astype(np.float64))
            w = w64.astype(np.float32)
        if g.dtype == np.float32:
            assert np.array_equal(np.isnan(g), np.isnan(w)), mode
            g, w = g[~np.isnan(g)], w[~np.isnan(w)]
        if mode == "sum" and v.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        else:  # bit for bit: +-0 count as +0, so min and max are exact
            np.testing.assert_array_equal(g.view(np.int32) if g.dtype ==
                                          np.float32 else g,
                                          w.view(np.int32) if w.dtype ==
                                          np.float32 else w)


def test_segment_reduce_host_helpers():
    """The instance and load routes the wrapper picks, from the requests'
    footprint and the inputs' alignment."""
    f = torch.zeros(8)
    i = torch.zeros(8, dtype=torch.int32)
    # the headline's count + f32 sum over 64 slots: per-thread instance
    assert per_thread_accumulators(64, [(None, None, "count"),
                                        (f, None, "sum")])
    # two f32 sums over 300 slots, 16 requests over 2048: per-warp
    assert not per_thread_accumulators(300, [(f, None, "sum")] * 2)
    assert not per_thread_accumulators(2048, [(i, None, "max")] * 16)
    x = torch.zeros(64, dtype=torch.int32)
    assert seg_vector_loads([x, x[4:]]) and not seg_vector_loads([x, x[1:]])


def _sum64_keys(rng, n):
    """Two key lanes (an INT32 one with rows below and past its domain, an
    INT64 one past int32) over K = 6 x 2 = 12 slots, a keep mask and a row
    count; slot 11 (k1 = 2, k2 = 1) gets no row.  Returns (keys, keep,
    num_rows, the slot of each live row or -1, the live rows dropped)."""
    k1 = rng.integers(-5, 5, n).astype(np.int32)  # domain [-3, 3)
    big = 5_000_000_000
    k2 = big + rng.integers(0, 2, n)
    k2[(k1 == 2) & (k2 == big + 1)] = big
    keep = rng.random(n) < 0.9
    num_rows = n - 17
    ids, live, bad = _jax_ids([(k1, -3, 6), (k2, big, 2)], keep, num_rows)
    assert bad > 0 and not (ids == 11).any()
    return [(k1, -3, 6), (k2, big, 2)], keep, num_rows, ids, bad


@pytest.mark.parametrize("case", ["f64", "f32_widened", "i64_wraps",
                                  "i32_widened"])
def test_segment_reduce_sum64_matches_numpy(case):
    """The plain version of the 64-bit sum words (``sum64``: SUM_F64 and
    SUM_I64) against numpy, over two key lanes with live rows dropped out
    of the domain, a keep mask, a row count and NULL values: f64 slots
    holding a NaN, an inf, both infinities, only -0.0 (+0.0 out: a sum
    starts at +0.0) and no rows (0); i64 sums wrapping past INT64_MAX; f32
    and i32 values widened a row (so no f32 rounding, no int32 wrap)."""
    rng = np.random.default_rng(40 + len(case))
    n = 5000
    keys, keep, num_rows, ids, want_bad = _sum64_keys(rng, n)
    valid = rng.random(n) < 0.85
    ok = (ids >= 0) & valid
    if case in ("f64", "f32_widened"):
        dt = np.float64 if case == "f64" else np.float32
        v = (rng.standard_normal(n) * 1e3).astype(dt)
        where = lambda s: np.flatnonzero(ok & (ids == s))  # noqa: E731
        v[where(0)[0]] = np.nan
        v[where(1)[0]] = np.inf
        v[where(2)[:2]] = [np.inf, -np.inf]
        v[ids == 10] = -0.0
        want = np.zeros(12)
        with np.errstate(invalid="ignore"):  # inf + -inf in slot 2
            np.add.at(want, ids[ok], v[ok].astype(np.float64))
    else:
        if case == "i64_wraps":
            v = rng.integers(2**61, 2**63 - 1, n)
        else:
            v = rng.integers(2**30, 2**31 - 1, n).astype(np.int32)
        want = np.zeros(12, np.int64)
        np.add.at(want, ids[ok], v[ok].astype(np.int64))  # wraps mod 2^64
        exact = [int(v[ok & (ids == s)].astype(object).sum())
                 for s in range(12)]
        assert max(exact) > (2**63 if case == "i64_wraps" else 2**31)
    t = torch.from_numpy
    (got, cnt), bad = segment_reduce_keyed(
        [(t(lane), kmin, k) for lane, kmin, k in keys],
        [(t(v), t(valid), "sum64"), (None, t(valid), "count")], 12,
        keep=t(keep), num_rows=num_rows)
    assert int(bad) == want_bad
    got = got.numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(cnt.numpy(), np.bincount(ids[ok], minlength=12))
    if got.dtype == np.float64:
        assert np.isnan(got[0]) and np.isnan(got[2]) and got[1] == np.inf
        assert got[10] == 0 and not np.signbit(got[10]) and got[11] == 0
        np.testing.assert_allclose(got, want, rtol=1e-13, equal_nan=True)
    else:
        assert np.array_equal(got, want)


def test_per_thread_accumulators_reckon_8_byte_words():
    """``sum64`` words take 8 bytes: an f64 sum (or an f32 widened into
    one) 2 KB a slot per block, an i64 sum 64 bytes a slot; so Q1's five
    f64 sums with a count and firstpos over K = 6 take the per-thread
    instance, and the edges move to half the 4-byte words' K."""
    d = torch.zeros(8, dtype=torch.float64)
    f = torch.zeros(8)
    l = torch.zeros(8, dtype=torch.int64)
    i = torch.zeros(8, dtype=torch.int32)
    q1 = [(None, None, "count"), (None, None, "firstpos")] + [
        (d, None, "sum64")] * 5
    assert per_thread_accumulators(6, q1)
    assert per_thread_accumulators(113, [(d, None, "sum64")])
    assert not per_thread_accumulators(114, [(d, None, "sum64")])
    assert not per_thread_accumulators(114, [(f, None, "sum64")])
    assert per_thread_accumulators(114, [(f, None, "sum")])
    assert not per_thread_accumulators(2048, [(d, None, "sum64")])
    assert per_thread_accumulators(2048, [(l, None, "sum64")])
    assert not per_thread_accumulators(2048, [(l, None, "sum64")] * 2)
    assert not per_thread_accumulators(2048, [(i, None, "sum64")] * 2)
    assert per_thread_accumulators(2048, [(i, None, "sum")] * 2)


@pytest.mark.parametrize("bad_call", [
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(None, None, "sum")], 4),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(None, None, "count")], 5),
    lambda k: segment_reduce_keyed([(k.float(), 0, 4)],
                                   [(None, None, "count")], 4),
    lambda k: segment_reduce_keyed([(k, 0, 2)] * 5, [(None, None, "count")],
                                   32),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(None, None, "median")], 4),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(k.float(), None,
                                                  "firstpos")], 4),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(None, None, "sum64")], 4),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(k.double(), None, "sum")],
                                   4),
    lambda k: segment_reduce_keyed([(k, 0, 4)], [(k.double(), None, "max")],
                                   4),
], ids=["sum_without_values", "domain_mismatch", "float_key",
        "five_keys", "unknown_mode", "float_positions", "sum64_without_values",
        "f64_into_a_32_bit_sum", "f64_max"])
def test_segment_reduce_keyed_rejects_bad_calls(bad_call):
    with pytest.raises(ValueError):
        bad_call(torch.zeros(8, dtype=torch.int32))


def test_cpu_wrappers_launch_no_kernel():
    kernels.reset_launches()
    m = torch.ones(8, dtype=torch.bool)
    compact_kernel([torch.arange(8)], m, 8)
    lut_gather([torch.arange(8)], torch.zeros(8, dtype=torch.int32), 8)
    segment_reduce_multi([(torch.ones(8), "sum")],
                         torch.zeros(8, dtype=torch.int32), 2)
    segment_reduce_keyed([(torch.zeros(8, dtype=torch.int32), 0, 2)],
                         [(None, None, "count")], 2)
    spread_kernel([torch.arange(8)], torch.arange(8, dtype=torch.int32), 9)
    k = torch.arange(8, dtype=torch.int32)
    merge_sorted([k, k.double()], [k, k.double()], [MergeKey(1, False)], 16)
    assert kernels.launches == {"compaction": 0, "lut_gather": 0,
                                "segment_reduce": 0,
                                "segment_reduce_small": 0, "spread": 0,
                                "merge_sorted": 0}
