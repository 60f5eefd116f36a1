"""Filter and row compaction against numpy: selectivity sweeps, nullable,
64-bit and bool columns, mixed RecordBatches, and the stable partition that
carries every compaction (`utils.scans.stable_partition`)."""

import numpy as np
import pytest

import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu import compute as ac
from arrow_tpu.array.boolean import BooleanArray
from arrow_tpu.table import RecordBatch
from arrow_tpu.utils.scans import stable_partition


def _mask(bools):
    return BooleanArray.from_slice(bools.tolist())


@pytest.mark.parametrize("sel_p", [0.0, 0.01, 0.3, 0.77, 1.0])
def test_compact_rows(sel_p):
    n = 16384
    rng = np.random.default_rng(3)
    data = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    mask = rng.random(n) < sel_p
    (out,) = stable_partition(jnp.asarray(mask), [jnp.asarray(data)])
    k = int(mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[:k], data[mask])


def test_filter_sort_method():
    a = at.Float32Array.from_slice(np.arange(2048, dtype=np.float32))
    m = at.BooleanArray.from_slice(np.arange(2048) % 3 == 0)
    r = ac.filter(a, m, method="sort")
    assert len(r) == int((np.arange(2048) % 3 == 0).sum())
    np.testing.assert_array_equal(r.raw_values(), np.arange(0, 2048, 3, dtype=np.float32))


@pytest.mark.parametrize("sel_p", [0.0, 0.02, 0.5, 0.97, 1.0])
def test_u32_plain(sel_p):
    rng = np.random.default_rng(42)
    n = 20_000
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    mask = rng.random(n) < sel_p
    a = at.UInt32Array.from_slice(vals)
    out = ac.filter(a, _mask(mask))
    np.testing.assert_array_equal(out.raw_values(), vals[mask])


def test_f32_nullable():
    rng = np.random.default_rng(7)
    n = 10_000
    vals = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.8
    mask = rng.random(n) < 0.5
    a = at.Float32Array.from_optional_slice(
        [float(v) if ok else None for v, ok in zip(vals, valid)]
    )
    out = ac.filter(a, _mask(mask))
    exp_v, exp_ok = vals[mask], valid[mask]
    got = out.values()
    assert len(got) == exp_v.shape[0]
    for g, v, ok in zip(got, exp_v, exp_ok):
        if ok:
            assert g == pytest.approx(float(v))
        else:
            assert g is None


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_64bit(dtype):
    rng = np.random.default_rng(3)
    n = 9_000
    if dtype == np.float64:
        vals = rng.random(n).astype(np.float64)
        a = at.Float64Array.from_slice(vals)
    elif dtype == np.int64:
        vals = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
        a = at.Int64Array.from_slice(vals)
    else:
        vals = rng.integers(0, 2**64, n, dtype=np.uint64)
        a = at.UInt64Array.from_slice(vals)
    mask = rng.random(n) < 0.4
    out = ac.filter(a, _mask(mask))
    np.testing.assert_array_equal(out.raw_values(), vals[mask])


def test_bool_column():
    rng = np.random.default_rng(5)
    n = 8_192
    vals = rng.random(n) < 0.5
    mask = rng.random(n) < 0.6
    a = BooleanArray.from_slice(vals.tolist())
    out = ac.filter(a, _mask(mask))
    np.testing.assert_array_equal(np.asarray(out.values()), vals[mask])


def test_recordbatch_mixed():
    rng = np.random.default_rng(11)
    n = 12_000
    c1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    c2 = rng.random(n).astype(np.float32)
    c2_valid = rng.random(n) < 0.7
    c3 = rng.integers(0, 2**63, n, dtype=np.uint64)
    c4 = rng.random(n) < 0.5
    mask = rng.random(n) < 0.33
    batch = RecordBatch(
        {
            "a": at.UInt32Array.from_slice(c1),
            "b": at.Float32Array.from_optional_slice(
                [float(v) if ok else None for v, ok in zip(c2, c2_valid)]
            ),
            "c": at.UInt64Array.from_slice(c3),
            "d": BooleanArray.from_slice(c4.tolist()),
        }
    )
    out = ac.filter(batch, _mask(mask))
    assert out.num_rows == int(mask.sum())
    np.testing.assert_array_equal(out["a"].raw_values(), c1[mask])
    np.testing.assert_array_equal(out["c"].raw_values(), c3[mask])
    np.testing.assert_array_equal(np.asarray(out["d"].values()), c4[mask])
    got_b = out["b"].values()
    for g, v, ok in zip(got_b, c2[mask], c2_valid[mask]):
        assert (g is None) == (not ok)
        if ok:
            assert g == pytest.approx(float(v))


def test_auto_matches_sort_path():
    rng = np.random.default_rng(13)
    n = 16_384
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int32)
    mask = rng.random(n) < 0.5
    a = at.Int32Array.from_slice(vals)
    out_a = ac.filter(a, _mask(mask), method="auto")
    out_s = ac.filter(a, _mask(mask), method="sort")
    np.testing.assert_array_equal(out_a.raw_values(), out_s.raw_values())
    np.testing.assert_array_equal(out_a.raw_values(), vals[mask])


def test_value_planes_zero_padded():
    """Rows [count, n) of filtered value buffers are zero."""
    rng = np.random.default_rng(11)
    n = 8192
    vals = rng.integers(1, 2**31, n, dtype=np.uint32)  # all nonzero
    mask = rng.random(n) < 0.3
    a = at.UInt32Array.from_slice(vals)
    out = ac.filter(a, _mask(mask))
    buf = np.asarray(out.data)
    k = len(out)
    assert (buf[k:] == 0).all()

    v64 = rng.integers(1, 2**62, n, dtype=np.uint64)
    a64 = at.UInt64Array.from_slice(v64)
    out64 = ac.filter(a64, _mask(mask))
    buf64 = np.asarray(out64.data)
    assert (buf64[len(out64):] == 0).all()


@pytest.mark.parametrize("sel_p", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_split_partition(sel_p):
    """Both halves of one partition: selected rows first, then the rest,
    each in original order, every plane moved together."""
    rng = np.random.default_rng(int(sel_p * 100) + 3)
    n = 16384
    a = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    mask = rng.random(n) < sel_p
    sa, sb = stable_partition(jnp.asarray(mask), [jnp.asarray(a), jnp.asarray(b)])
    c = int(mask.sum())
    np.testing.assert_array_equal(np.asarray(sa)[:c], a[mask])
    np.testing.assert_array_equal(np.asarray(sb)[:c], b[mask])
    np.testing.assert_array_equal(np.asarray(sa)[c:], a[~mask])
    np.testing.assert_array_equal(np.asarray(sb)[c:], b[~mask])
