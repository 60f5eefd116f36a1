"""Group-by cases against numpy: dense small-key domains, wide, skewed and
padded inputs, 64-bit and negative values, all through the one sort program
that `hash_aggregate` runs."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.compute.hash_aggregate import hash_aggregate
from arrow_tpu.errors import OperationNotSupported


def _np_groups(keys, vals=None):
    uk, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv, minlength=uk.size)
    sums = None
    if vals is not None:
        sums = np.zeros(uk.size, np.int64)
        np.add.at(sums, inv, np.asarray(vals, np.int64))
    return uk, counts, sums


def test_dense_domain_exact_vs_numpy():
    rng = np.random.default_rng(0)
    n = 16384
    keys = rng.integers(0, 4096, n).astype(np.uint32)
    vals = rng.integers(0, 2**31 - 1, n).astype(np.uint32)
    out = hash_aggregate(
        at.UInt32Array.from_slice(keys),
        [("c", None, "count"), ("s", at.UInt32Array.from_slice(vals), "sum")],
    )
    uk, counts, sums = _np_groups(keys, vals)
    np.testing.assert_array_equal(out["key"].raw_values(), uk)
    np.testing.assert_array_equal(out["c"].raw_values(), counts)
    # u32 sums wrap like the column type
    np.testing.assert_array_equal(out["s"].raw_values(), sums.astype(np.uint32))


def test_public_api_matches_sort_path():
    rng = np.random.default_rng(1)
    n = 10_000
    keys_np = rng.integers(0, 1024, n).astype(np.uint32)
    vals_np = rng.integers(0, 200, n).astype(np.int32)
    keys = at.UInt32Array.from_slice(keys_np)
    vals = at.Int32Array.from_slice(vals_np)
    spec = [("s", vals, "sum"), ("c", vals, "count"), ("m", vals, "mean"), ("n", None, "count")]
    out_auto = hash_aggregate(keys, spec)
    out_sort = hash_aggregate(keys, spec, method="sort")
    assert out_auto.num_rows == out_sort.num_rows
    for col in ("key", "s", "c", "n"):
        np.testing.assert_array_equal(out_auto[col].raw_values(), out_sort[col].raw_values())
    uk, counts, sums = _np_groups(keys_np, vals_np)
    np.testing.assert_array_equal(out_auto["s"].raw_values(), sums)
    np.testing.assert_allclose(out_auto["m"].raw_values(), sums / counts, rtol=1e-12)


def test_wide_keys_ascending_groups():
    rng = np.random.default_rng(2)
    n = 8192
    keys = at.UInt32Array.from_slice(rng.integers(0, 2**30, n).astype(np.uint32))
    vals = at.Int32Array.from_slice(rng.integers(0, 100, n).astype(np.int32))
    out = hash_aggregate(keys, [("s", vals, "sum")])
    ks = np.asarray(out["key"].raw_values())
    assert out.num_rows == np.unique(np.asarray(keys.raw_values())).size
    assert (np.diff(ks) > 0).all()
    with pytest.raises(OperationNotSupported):
        hash_aggregate(keys, [("s", vals, "sum")], method="mxu")


def test_negative_values():
    rng = np.random.default_rng(3)
    n = 8192
    kn = rng.integers(0, 64, n).astype(np.uint32)
    vn = rng.integers(-100, 100, n).astype(np.int32)
    out = hash_aggregate(
        at.UInt32Array.from_slice(kn), [("s", at.Int32Array.from_slice(vn), "sum")]
    )
    exp = np.zeros(64, np.int64)
    np.add.at(exp, kn, vn.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(out["s"].raw_values(), dtype=np.int64), exp[np.unique(kn)]
    )


def test_64bit_values_exact():
    """Values >= 2^32 sum without truncation."""
    rng = np.random.default_rng(4)
    n = 8192
    kn = rng.integers(0, 16, n).astype(np.uint32)
    big = rng.integers(2**33, 2**40, n).astype(np.int64)
    out = hash_aggregate(
        at.UInt32Array.from_slice(kn), [("s", at.Int64Array.from_slice(big), "sum")]
    )
    exp = np.zeros(16, np.int64)
    np.add.at(exp, kn, big)
    np.testing.assert_array_equal(
        np.asarray(out["s"].raw_values(), dtype=np.int64), exp[np.unique(kn)]
    )


def test_padded_buffer_rows_are_zero():
    """Rows >= num_groups of every output buffer are zero."""
    rng = np.random.default_rng(5)
    n = 8192
    keys = at.UInt32Array.from_slice(rng.integers(0, 7, n).astype(np.uint32))
    vals = at.Int32Array.from_slice(rng.integers(1, 100, n).astype(np.int32))
    out = hash_aggregate(keys, [("s", vals, "sum"), ("c", vals, "count")])
    g = out.num_rows
    for col in ("key", "s", "c"):
        buf = np.asarray(out[col].data)
        assert (buf[g:] == 0).all(), f"{col} rows >= num_groups not zeroed"


def test_small_domain_narrow_values():
    rng = np.random.default_rng(6)
    n = 8192
    kn = rng.integers(0, 256, n).astype(np.uint32)
    vn = rng.integers(0, 200, n).astype(np.int32)
    out = hash_aggregate(
        at.UInt32Array.from_slice(kn), [("s", at.Int32Array.from_slice(vn), "sum")]
    )
    exp = np.zeros(256, np.int64)
    np.add.at(exp, kn, vn.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(out["s"].raw_values(), dtype=np.int64), exp[np.unique(kn)]
    )
    with pytest.raises(TypeError):
        hash_aggregate(
            at.UInt32Array.from_slice(kn),
            [("s", at.Int32Array.from_slice(vn), "sum")],
            key_domain=(0, 256),
        )


def test_sort_path_dense_no_padding():
    """Dense fast path (length == padded capacity, no nulls): the sort drops
    rank/validity operands; results must match the general path exactly."""
    rng = np.random.default_rng(9)
    n = 8192  # == pad_len(n)
    keys_np = rng.integers(0, 300, n).astype(np.uint32)
    vals_np = rng.integers(-50, 50, n).astype(np.int32)
    out = hash_aggregate(
        at.UInt32Array.from_slice(keys_np),
        [("s", at.Int32Array.from_slice(vals_np), "sum"), ("c", None, "count")],
        method="sort",
    )
    uk = np.unique(keys_np)
    assert out.num_rows == uk.size
    exp = np.array([vals_np[keys_np == k].sum() for k in uk], np.int64)
    np.testing.assert_array_equal(np.asarray(out["s"].raw_values(), np.int64), exp)
    np.testing.assert_array_equal(
        np.asarray(out["c"].raw_values(), np.int64), np.bincount(keys_np)[uk]
    )


def test_mid_domain_padded_input():
    """Keys up to 50000 over a length that pads (20000 -> 24576 rows)."""
    rng = np.random.default_rng(7)
    n = 20000
    keys = rng.integers(0, 50000, n).astype(np.uint32)
    vals = rng.integers(0, 250, n).astype(np.int32)
    va = at.Int32Array.from_slice(vals)
    got = hash_aggregate(
        at.UInt32Array.from_slice(keys), [("s", va, "sum"), ("c", None, "count"), ("m", va, "mean")]
    )
    uk, counts, sums = _np_groups(keys, vals)
    np.testing.assert_array_equal(got["key"].raw_values(), uk)
    np.testing.assert_array_equal(got["c"].raw_values(), counts)
    np.testing.assert_array_equal(got["s"].raw_values(), sums)
    np.testing.assert_allclose(got["m"].raw_values(), sums / counts, rtol=1e-12)


def test_skewed_keys():
    """~80% of rows on three keys, the rest sprayed over 2^18."""
    rng = np.random.default_rng(8)
    n = 16384
    hot = rng.choice([5, 77, 4000], int(n * 0.8))
    cold = rng.integers(0, 1 << 18, n - hot.shape[0])
    keys = np.concatenate([hot, cold]).astype(np.uint32)
    rng.shuffle(keys)
    vals = rng.integers(0, 200, n).astype(np.int32)
    got = hash_aggregate(
        at.UInt32Array.from_slice(keys),
        [("s", at.Int32Array.from_slice(vals), "sum"), ("c", None, "count")],
    )
    uk, counts, sums = _np_groups(keys, vals)
    np.testing.assert_array_equal(got["key"].raw_values(), uk)
    np.testing.assert_array_equal(got["c"].raw_values(), counts)
    np.testing.assert_array_equal(got["s"].raw_values(), sums)


def test_auto_matches_sort_small_domain():
    rng = np.random.default_rng(7)
    n = 8192
    ka = at.UInt32Array.from_slice(rng.integers(0, 50, n).astype(np.uint32))
    va = at.Int32Array.from_slice(rng.integers(0, 1000, n).astype(np.int32))
    spec = [("s", va, "sum"), ("c", va, "count")]
    out = hash_aggregate(ka, spec)
    ref = hash_aggregate(ka, spec, method="sort")
    for col in ("key", "s", "c"):
        np.testing.assert_array_equal(out[col].raw_values(), ref[col].raw_values())


def test_min_max_sum_count_vs_numpy():
    rng = np.random.default_rng(5)
    keys_np = rng.integers(0, 200, 8192).astype(np.uint32)
    vals_np = rng.integers(-50, 50, 8192).astype(np.int32)
    vals = at.Int32Array.from_slice(vals_np)
    spec = [("s", vals, "sum"), ("c", vals, "count"), ("mn", vals, "min"), ("mx", vals, "max")]
    out = hash_aggregate(at.UInt32Array.from_slice(keys_np), spec)
    uk = np.unique(keys_np)
    assert out.num_rows == uk.size
    np.testing.assert_array_equal(
        np.asarray(out["s"].raw_values(), np.int64),
        [vals_np[keys_np == k].sum() for k in uk],
    )
    np.testing.assert_array_equal(
        out["mn"].raw_values(), [vals_np[keys_np == k].min() for k in uk]
    )
    np.testing.assert_array_equal(
        out["mx"].raw_values(), [vals_np[keys_np == k].max() for k in uk]
    )
    np.testing.assert_array_equal(out["c"].raw_values(), np.bincount(keys_np)[uk])
