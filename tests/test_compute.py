"""Operator tier tests: filter, sort, hash aggregate, hash join — differential
against numpy references across sizes, selectivities, and skew (the analog of
BASELINE.md's config sweeps at test scale)."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import compute as C
from arrow_tpu.table import RecordBatch

from helpers import assert_values_eq


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------


def test_filter_basic():
    a = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0, 5.0])
    m = at.BooleanArray.from_slice([True, False, True, False, True])
    r = C.filter(a, m)
    assert len(r) == 3
    assert_values_eq(r.values(), [1.0, 3.0, 5.0], 0.01)


def test_filter_null_mask_rows_dropped():
    a = at.Int32Array.from_slice([1, 2, 3, 4])
    m = at.BooleanArray.from_optional_slice([True, None, True, False])
    r = C.filter(a, m)
    assert r.values() == [1, 3]


def test_filter_carries_validity():
    a = at.Int32Array.from_optional_slice([1, None, 3, None])
    m = at.BooleanArray.from_slice([True, True, False, True])
    r = C.filter(a, m)
    assert r.values() == [1, None, None]


def test_filter_bool_column():
    a = at.BooleanArray.from_slice([True, False, True, False])
    m = at.BooleanArray.from_slice([True, True, False, True])
    assert C.filter(a, m).values() == [True, False, False]


def test_filter_record_batch():
    rb = RecordBatch.from_numpy(
        {"x": np.arange(6, dtype=np.int32), "y": np.arange(6, dtype=np.float32) * 2}
    )
    m = at.BooleanArray.from_slice([False, True, True, False, False, True])
    out = C.filter(rb, m)
    assert out.num_rows == 3
    assert out["x"].values() == [1, 2, 5]
    assert out["y"].values() == [2.0, 4.0, 10.0]


@pytest.mark.parametrize("selectivity", [0.01, 0.5, 0.99])
def test_filter_selectivity_sweep(selectivity):
    rng = np.random.default_rng(42)
    n = 100_000
    x = rng.integers(0, 1 << 30, n).astype(np.int32)
    keep = rng.random(n) < selectivity
    a = at.Int32Array.from_slice(x)
    m = at.BooleanArray.from_slice(keep)
    r = C.filter(a, m)
    np.testing.assert_array_equal(np.asarray(r.raw_values()), x[keep])
    assert C.filter_count(m) == int(keep.sum())


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def test_sort_basic():
    a = at.UInt32Array.from_slice(np.array([5, 1, 4, 2, 3], np.uint32))
    assert C.sort(a).values() == [1, 2, 3, 4, 5]
    assert C.sort(a, descending=True).values() == [5, 4, 3, 2, 1]
    order = C.argsort(a)
    assert order.values() == [1, 3, 4, 2, 0]


def test_sort_nulls_last_stable():
    a = at.Int32Array.from_optional_slice([3, None, 1, None, 2])
    assert C.sort(a).values() == [1, 2, 3, None, None]


def test_sort_negative_and_floats():
    a = at.Int32Array.from_slice([-5, 3, -1, 0])
    assert C.sort(a).values() == [-5, -1, 0, 3]
    f = at.Float32Array.from_slice([2.5, -1.5, 0.0])
    assert C.sort(f).values() == [-1.5, 0.0, 2.5]
    assert C.sort(f, descending=True).values() == [2.5, 0.0, -1.5]


def test_sort_by_key_payload():
    k = at.UInt32Array.from_slice(np.array([3, 1, 2], np.uint32))
    p = at.Float32Array.from_slice([30.0, 10.0, 20.0])
    sk, sp = C.sort_by_key(k, p)
    assert sk.values() == [1, 2, 3]
    assert_values_eq(sp.values(), [10.0, 20.0, 30.0], 0.01)


def test_sort_by_key_batch_payload():
    k = at.Int64Array.from_slice([30, 10, 20])
    rb = RecordBatch.from_numpy({"a": np.int32([1, 2, 3]), "b": np.float32([0.1, 0.2, 0.3])})
    sk, srb = C.sort_by_key(k, rb)
    assert sk.values() == [10, 20, 30]
    assert srb["a"].values() == [2, 3, 1]


def test_sort_stability():
    """Stable: equal keys keep input order."""
    k = at.UInt32Array.from_slice(np.array([1, 0, 1, 0, 1], np.uint32))
    p = at.Int32Array.from_slice([0, 1, 2, 3, 4])
    _, sp = C.sort_by_key(k, p)
    assert sp.values() == [1, 3, 0, 2, 4]


def test_sort_large_random():
    rng = np.random.default_rng(7)
    for npdt, cls in [(np.uint32, at.UInt32Array), (np.int64, at.Int64Array)]:
        x = rng.integers(0, 1 << 30, 200_000).astype(npdt)
        got = np.asarray(C.sort(cls.from_slice(x)).raw_values())
        np.testing.assert_array_equal(got, np.sort(x))


# ---------------------------------------------------------------------------
# hash aggregate
# ---------------------------------------------------------------------------


def test_hash_aggregate_basic():
    keys = at.UInt32Array.from_slice(np.array([1, 2, 1, 3, 2, 1], np.uint32))
    vals = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    out = C.hash_aggregate(
        keys,
        [("s", vals, "sum"), ("c", None, "count"), ("mn", vals, "min"), ("mx", vals, "max")],
    )
    assert out["key"].values() == [1, 2, 3]
    assert_values_eq(out["s"].values(), [10.0, 7.0, 4.0], 0.01)
    assert out["c"].values() == [3, 2, 1]
    assert_values_eq(out["mn"].values(), [1.0, 2.0, 4.0], 0.01)
    assert_values_eq(out["mx"].values(), [6.0, 5.0, 4.0], 0.01)


def test_hash_aggregate_null_keys_dropped_null_values_skipped():
    keys = at.UInt32Array.from_optional_slice([1, None, 1, 2])
    vals = at.Int32Array.from_optional_slice([10, 20, None, 40])
    out = C.hash_aggregate(keys, [("s", vals, "sum"), ("c", vals, "count")])
    assert out["key"].values() == [1, 2]
    assert out["s"].values() == [10, 40]
    assert out["c"].values() == [1, 1]


def test_hash_aggregate_skewed_differential():
    rng = np.random.default_rng(3)
    n = 200_000
    # heavy-hitter skew: 90% of rows in 3 keys, rest uniform over 10k keys
    hot = rng.choice([7, 11, 13], size=int(n * 0.9))
    cold = rng.integers(0, 10_000, size=n - hot.shape[0])
    keys_np = np.concatenate([hot, cold]).astype(np.uint32)
    rng.shuffle(keys_np)
    vals_np = rng.integers(-100, 100, n).astype(np.int32)
    out = C.hash_aggregate(
        at.UInt32Array.from_slice(keys_np),
        [("s", at.Int32Array.from_slice(vals_np), "sum"), ("c", None, "count")],
    )
    uk = np.unique(keys_np)
    assert out["key"].values() == uk.tolist()
    sums = np.zeros(uk.shape[0], np.int64)
    np.add.at(sums, np.searchsorted(uk, keys_np), vals_np)
    np.testing.assert_array_equal(np.asarray(out["s"].raw_values()), sums.astype(np.int32))
    counts = np.bincount(np.searchsorted(uk, keys_np)).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(out["c"].raw_values()), counts)


def test_hash_aggregate_mean():
    keys = at.Int32Array.from_slice([1, 1, 2])
    vals = at.Float32Array.from_slice([1.0, 2.0, 5.0])
    out = C.hash_aggregate(keys, [("m", vals, "mean")])
    assert_values_eq(out["m"].values(), [1.5, 5.0], 0.01)


# ---------------------------------------------------------------------------
# hash join
# ---------------------------------------------------------------------------


def test_join_indices_basic():
    build = at.UInt32Array.from_slice(np.array([10, 20, 30], np.uint32))
    probe = at.UInt32Array.from_slice(np.array([20, 99, 10, 20], np.uint32))
    pi, bi, t = C.join_indices(build, probe)
    assert t == 3
    pairs = sorted(zip(pi.values(), bi.values()))
    assert pairs == [(0, 1), (2, 0), (3, 1)]


def test_join_duplicates_both_sides():
    build = at.Int64Array.from_slice([1, 1, 2])
    probe = at.Int64Array.from_slice([1, 2, 2])
    pi, bi, t = C.join_indices(build, probe)
    # probe row 0 matches build rows {0,1}; probe rows 1,2 match build row 2
    assert t == 4
    got = sorted(zip(pi.values(), bi.values()))
    assert got == [(0, 0), (0, 1), (1, 2), (2, 2)]


def test_join_null_keys_never_match():
    build = at.UInt32Array.from_optional_slice([1, None, 3])
    probe = at.UInt32Array.from_optional_slice([None, 1, 3])
    pi, bi, t = C.join_indices(build, probe)
    assert t == 2
    assert sorted(zip(pi.values(), bi.values())) == [(1, 0), (2, 2)]


def test_hash_join_batches():
    left = RecordBatch.from_numpy(
        {"k": np.uint64([1, 2, 3, 2]), "lv": np.float32([0.1, 0.2, 0.3, 0.4])}
    )
    right = RecordBatch.from_numpy(
        {"k": np.uint64([2, 3, 4]), "rv": np.int32([200, 300, 400])}
    )
    out = C.hash_join(left, right, "k", "k")
    d = out.to_pydict()
    rows = sorted(zip(d["k"], d["lv"], d["rv"]))
    assert rows == [(2, pytest.approx(0.2, abs=0.01), 200),
                    (2, pytest.approx(0.4, abs=0.01), 200),
                    (3, pytest.approx(0.3, abs=0.01), 300)]


def test_join_max_key_edge():
    m = 2**32 - 1
    build = at.UInt32Array.from_optional_slice([m, None, 5])
    probe = at.UInt32Array.from_slice(np.array([m, 5], np.uint32))
    pi, bi, t = C.join_indices(build, probe)
    assert t == 2
    assert sorted(zip(pi.values(), bi.values())) == [(0, 0), (1, 2)]


def test_join_large_differential():
    rng = np.random.default_rng(11)
    nb, np_ = 50_000, 80_000
    bk = rng.integers(0, 30_000, nb).astype(np.uint64)
    pk = rng.integers(0, 30_000, np_).astype(np.uint64)
    pi, bi, t = C.join_indices(
        at.UInt64Array.from_slice(bk), at.UInt64Array.from_slice(pk)
    )
    # expected count via numpy
    cnt_b = np.bincount(bk.astype(np.int64), minlength=30_000)
    expected = int(cnt_b[pk.astype(np.int64)].sum())
    assert t == expected
    # verify every pair actually matches
    pi_np = np.asarray(pi.raw_values())[:t]
    bi_np = np.asarray(bi.raw_values())[:t]
    np.testing.assert_array_equal(pk[pi_np], bk[bi_np])


def test_join_u64_wide_keys_exercise_high_limb():
    rng = np.random.default_rng(12)
    nb, np_ = 20_000, 30_000
    # keys straddle 2**32 with colliding low limbs: hi limb must participate
    lo = rng.integers(0, 1_000, nb).astype(np.uint64)
    hi = rng.integers(0, 4, nb).astype(np.uint64) << np.uint64(32)
    bk = hi | lo
    lo_p = rng.integers(0, 1_000, np_).astype(np.uint64)
    hi_p = rng.integers(0, 4, np_).astype(np.uint64) << np.uint64(32)
    pk = hi_p | lo_p
    pi, bi, t = C.join_indices(
        at.UInt64Array.from_slice(bk), at.UInt64Array.from_slice(pk)
    )
    sb = np.sort(bk)
    expected = int(
        (np.searchsorted(sb, pk, "right") - np.searchsorted(sb, pk, "left")).sum()
    )
    assert t == expected
    pi_np = np.asarray(pi.raw_values())[:t]
    bi_np = np.asarray(bi.raw_values())[:t]
    np.testing.assert_array_equal(pk[pi_np], bk[bi_np])


def test_join_i64_negative_keys():
    rng = np.random.default_rng(13)
    bk = rng.integers(-50, 50, 5_000).astype(np.int64) * (1 << 33)
    pk = rng.integers(-50, 50, 7_000).astype(np.int64) * (1 << 33)
    pi, bi, t = C.join_indices(
        at.Int64Array.from_slice(bk), at.Int64Array.from_slice(pk)
    )
    sb = np.sort(bk)
    expected = int(
        (np.searchsorted(sb, pk, "right") - np.searchsorted(sb, pk, "left")).sum()
    )
    assert t == expected
    pi_np = np.asarray(pi.raw_values())[:t]
    bi_np = np.asarray(bi.raw_values())[:t]
    np.testing.assert_array_equal(pk[pi_np], bk[bi_np])


def test_lex_sort():
    k1 = at.UInt32Array.from_slice(np.array([2, 1, 2, 1], np.uint32))
    k2 = at.Int32Array.from_slice([5, 9, 3, 7])
    p = at.Float32Array.from_slice([0.1, 0.2, 0.3, 0.4])
    keys, payload, order = C.lex_sort([k1, k2], p)
    assert keys[0].values() == [1, 1, 2, 2]
    assert keys[1].values() == [7, 9, 3, 5]
    assert order.values() == [3, 1, 2, 0]
    assert_values_eq(payload.values(), [0.4, 0.2, 0.3, 0.1], 0.01)
    keys_d, _, _ = C.lex_sort([k1, k2], descending=True)
    assert keys_d[0].values() == [2, 2, 1, 1]
    assert keys_d[1].values() == [5, 3, 9, 7]

