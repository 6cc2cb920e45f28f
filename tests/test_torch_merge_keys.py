"""The merge kernel's key description on the CPU: the port's
``merge_sorted`` over raw key columns (its wrapper runs the plain version
for CPU tensors, which codes the keys with ``key_words``) against the JAX
package's MergeUnionAll on the same seeded inputs (its ``lax.sort`` route on
the CPU), for every key type, ASC and DESC, with and without NULLs, with
NaNs of both signs and zeros of both signs in float keys; and the plain
version against the lane-form reference it builds on.  The CUDA kernel is
held against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import supersonic_tpu as J
from supersonic_tpu_torch.kernels.merge_sorted import (MergeKey,
                                                       merge_lanes_ref,
                                                       merge_sorted,
                                                       merge_sorted_ref)

from torch_parity import schema

torch.set_num_threads(1)

_TYPES = ["INT32", "INT64", "FLOAT", "DOUBLE", "BOOL", "STRING"]
_WORDS = [f"s{i:02d}" for i in range(23)]


def _child(rng, n, type_, asc, nullable):
    """(values, validity, JAX column data) of one child, sorted by the key
    in the merge order: NULL first ascending and last descending, NaN last
    either way, ties (and -0.0 with +0.0) in row order."""
    if type_ in ("FLOAT", "DOUBLE"):
        v = np.round(rng.standard_normal(n) * 3) / 2
        u = rng.random(n)
        v[u < 0.08] = np.nan
        v[(u >= 0.08) & (u < 0.16)] = -np.nan
        v[(u >= 0.16) & (u < 0.24)] = -0.0
        v = v.astype(np.float32 if type_ == "FLOAT" else np.float64)
    elif type_ == "BOOL":
        v = rng.random(n) < 0.5
    elif type_ == "STRING":
        v = rng.integers(0, len(_WORDS), n).astype(np.int32)  # sorted codes
    else:
        v = rng.integers(-40, 40, n).astype(
            np.int32 if type_ == "INT32" else np.int64) * (1 << 20 if
                                                           type_ == "INT64"
                                                           else 1)
    ok = rng.random(n) >= 0.2 if nullable else np.ones(n, bool)
    nan = np.isnan(v) if v.dtype.kind == "f" else np.zeros(n, bool)
    code = np.where(nan | ~ok, 0, v).astype(np.float64)
    rank = ok if asc else ~ok
    perm = np.lexsort((code if asc else -code, nan, rank))
    v, ok = v[perm], ok[perm]
    if type_ == "STRING":
        data = [_WORDS[c] if o else None for c, o in zip(v, ok)]
    elif nullable:
        data = [x.item() if o else None for x, o in zip(v, ok)]
    else:
        data = v
    return v, ok, data


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("type_", _TYPES)
def test_merge_sorted_key_description_matches_jax(type_, asc, nullable):
    """Three sorted children of (key, row id) merged by the key: the port's
    merge_sorted over the raw lanes, folded pairwise as MergeUnionAll folds,
    gives the JAX MergeUnionAll's rows."""
    rng = np.random.default_rng(_TYPES.index(type_) * 4 + asc * 2 + nullable)
    children = []
    for i, n in enumerate((700, 450, 600)):
        v, ok, data = _child(rng, n, type_, asc, nullable)
        ids = (np.arange(n) + 1000 * i).astype(np.int32)
        children.append((v, ok, data, ids))
    cols = (("k", type_, nullable), ("id", "INT32", False))
    jt = [J.Table.from_data(schema(J, cols), {"k": d, "id": ids})
          for _, _, d, ids in children]
    want = J.execute(J.MergeUnionAll([("k", asc)], [J.ScanTable(t)
                                                    for t in jt]))
    n = int(want.num_rows)
    w_ok = (np.asarray(want.columns["k"].valid)[:n].astype(bool) if nullable
            else np.ones(n, bool))
    w_id = np.asarray(want.columns["id"].values)[:n]
    w_k = np.asarray(want.columns["k"].values)[:n]
    if type_ == "STRING":
        w_k = np.searchsorted(_WORDS, want.dicts["k"].decode(
            np.where(w_ok, w_k, 0)))

    def lanes(v, ok, ids):
        ls = [torch.from_numpy(np.ascontiguousarray(v)),
              torch.from_numpy(ids)]
        return ls + [torch.from_numpy(ok)] if nullable else ls

    key = [MergeKey(0, asc, 2 if nullable else None)]
    got = lanes(*[children[0][j] for j in (0, 1, 3)])
    for c in children[1:]:
        got = merge_sorted(got, lanes(c[0], c[1], c[3]), key,
                           got[0].shape[0] + c[0].shape[0])
    assert got[0].shape[0] == n
    np.testing.assert_array_equal(got[1].numpy(), w_id)
    g_ok = got[2].numpy() if nullable else np.ones(n, bool)
    np.testing.assert_array_equal(g_ok, w_ok)
    g_k = got[0].numpy()[w_ok]
    w_k = w_k[w_ok]
    w_k = np.asarray(w_k).astype(g_k.dtype)
    if g_k.dtype.kind == "f":  # NaNs of both signs: compare bits
        bits = np.int64 if g_k.itemsize == 8 else np.int32
        g_k, w_k = g_k.view(bits), w_k.view(bits)
    np.testing.assert_array_equal(g_k, w_k)


@pytest.mark.parametrize("seed,lanes", [
    (1, [np.int32]),
    (2, [np.int64, np.int32]),
    (3, [np.int32, np.int64, np.int32]),
])
def test_plain_version_with_int_keys_equals_lane_form_reference(seed, lanes):
    """Plain int32/int64 ASC keys without validity are their own compare
    words: merge_sorted_ref over a key description gives exactly what the
    lane-form reference gives over the key lanes."""
    rng = np.random.default_rng(seed)

    def side(cap, live):
        ks = [rng.integers(-5, 5, live).astype(dt) for dt in lanes]
        order = np.lexsort(tuple(reversed(ks)))
        ks = [np.r_[k[order], rng.integers(-9, 9, cap - live).astype(k.dtype)]
              for k in ks]
        return [torch.from_numpy(k) for k in ks] + [
            torch.from_numpy(rng.standard_normal(cap))]

    a, b = side(3000, 2500), side(2000, 2000)
    keys = [MergeKey(i) for i in range(len(lanes))]
    for out_cap in (5000, 4100):
        got = merge_sorted_ref(a, b, keys, out_cap, 2500, 2000)
        kl, pays = merge_lanes_ref(a[:len(lanes)], a, b[:len(lanes)], b,
                                   out_cap, 2500, 2000)
        assert all(torch.equal(x, y) for x, y in zip(got, pays))
        assert all(torch.equal(x, y) for x, y in zip(got, kl))
