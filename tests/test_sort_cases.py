"""Sort, argsort and sort-by-key against stable numpy argsort: duplicate
keys, 64-bit and float keys, descending order, padded lengths, nulls and
mixed payload batches."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.compute.sort import argsort, sort, sort_by_key
from arrow_tpu.table import RecordBatch

N = 8192


def test_u32_key_payload_stable():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 200, N, dtype=np.uint32)
    v = np.arange(N, dtype=np.uint32)  # iota payload exposes stability
    ok, ov = sort_by_key(at.UInt32Array.from_slice(k), at.UInt32Array.from_slice(v))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), k[order])
    np.testing.assert_array_equal(ov.raw_values(), v[order])


def test_u32_descending():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 100, N, dtype=np.uint32)
    ok = sort(at.UInt32Array.from_slice(k), descending=True)
    np.testing.assert_array_equal(ok.raw_values(), np.sort(k, kind="stable")[::-1])


def test_u64_two_limb_keys():
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 16, N, dtype=np.uint64)
    hi = rng.integers(0, 8, N, dtype=np.uint64)
    k = (hi << np.uint64(32)) | lo
    v = np.arange(N, dtype=np.uint32)
    ok, ov = sort_by_key(at.UInt64Array.from_slice(k), at.UInt32Array.from_slice(v))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), k[order])
    np.testing.assert_array_equal(ov.raw_values(), v[order])


def test_padding_rows_stay_out():
    rng = np.random.default_rng(3)
    length = N - 700
    k = rng.integers(0, 64, length, dtype=np.uint32)
    ka = at.UInt32Array.from_slice(k)
    assert ka.data.shape[0] == N
    ok = sort(ka)
    assert len(ok) == length
    np.testing.assert_array_equal(ok.raw_values(), np.sort(k, kind="stable"))
    np.testing.assert_array_equal(np.asarray(ok.data[length:]), 0)


def test_w64_payload_and_bool_payload():
    rng = np.random.default_rng(4)
    k = rng.integers(0, 32, N, dtype=np.uint32)
    v64 = rng.integers(0, 1 << 40, N, dtype=np.uint64)
    vb = rng.integers(0, 2, N).astype(bool)
    p = RecordBatch(
        {"v": at.UInt64Array.from_slice(v64), "b": at.BooleanArray.from_slice(vb.tolist())}
    )
    ok, op = sort_by_key(at.UInt32Array.from_slice(k), p)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), k[order])
    np.testing.assert_array_equal(op["v"].raw_values(), v64[order])
    np.testing.assert_array_equal(np.asarray(op["b"].values()), vb[order])


def test_i32_and_f32_small_domains():
    rng = np.random.default_rng(5)
    ki = rng.integers(-3, 3, N).astype(np.int32)
    ok = sort(at.Int32Array.from_slice(ki))
    np.testing.assert_array_equal(ok.raw_values(), np.sort(ki, kind="stable"))

    kf = rng.choice(np.array([-2.5, -0.0, 0.0, 1.5, np.inf, -np.inf, np.nan], np.float32), N)
    got = sort(at.Float32Array.from_slice(kf)).raw_values()
    ref = np.sort(kf, kind="stable")
    np.testing.assert_array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])
    assert np.isnan(got[-np.isnan(got).sum():]).all()


def test_nullable_keys_sort_last():
    k = at.UInt32Array.from_optional_slice([3, None, 1] + [0] * 100)
    out = sort(k).values()
    assert out[:101] == [0] * 100 + [1] and out[101] == 3 and out[102] is None


def test_narrow_domain_payload_stable():
    rng = np.random.default_rng(11)
    k = rng.integers(0, 300, N, dtype=np.uint32)
    v = np.arange(N, dtype=np.uint32)
    ok, ov = sort_by_key(at.UInt32Array.from_slice(k), at.UInt32Array.from_slice(v))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), k[order])
    np.testing.assert_array_equal(ov.raw_values(), v[order])


def test_single_column_stable_dupes():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 7, 2 * N).astype(np.uint32)  # heavy duplicates
    out = sort(at.UInt32Array.from_slice(keys))
    np.testing.assert_array_equal(out.raw_values(), np.sort(keys, kind="stable"))


def test_payload_stability():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 5, 2 * N).astype(np.uint32)
    pay = np.arange(2 * N, dtype=np.uint32)  # row ids expose any instability
    ok, op = sort_by_key(at.UInt32Array.from_slice(keys), at.UInt32Array.from_slice(pay))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), keys[order])
    np.testing.assert_array_equal(op.raw_values(), pay[order])


def test_runt_length():
    rng = np.random.default_rng(2)
    n = 2 * N - 777
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    out = sort(at.UInt32Array.from_slice(keys))
    np.testing.assert_array_equal(out.raw_values(), np.sort(keys, kind="stable"))
    assert (np.asarray(out.data)[n:] == 0).all()  # zero-padding invariant


def test_multi_run_f32_with_infinities():
    rng = np.random.default_rng(3)
    n = 3 * N
    keys = rng.standard_normal(n).astype(np.float32)
    keys[:20] = np.inf
    keys[20:40] = -np.inf
    out = sort(at.Float32Array.from_slice(keys))
    np.testing.assert_array_equal(out.raw_values(), np.sort(keys, kind="stable"))


def test_batch_payload_mixed_dtypes():
    rng = np.random.default_rng(4)
    n = 2 * N
    keys = rng.integers(0, 50, n).astype(np.int32)
    p64 = rng.integers(-(2**60), 2**60, n).astype(np.int64)
    pb = rng.random(n) < 0.5
    p16 = rng.integers(0, 2**16, n).astype(np.uint16)
    nullable_vals = rng.integers(0, 100, n).astype(np.int32)
    nullable_ok = rng.random(n) < 0.8
    batch = RecordBatch(
        {
            "w64": at.Int64Array.from_slice(p64),
            "b": at.BooleanArray.from_slice(pb.tolist()),
            "small": at.UInt16Array.from_slice(p16),
            "nul": at.Int32Array.from_optional_slice(
                [int(v) if ok else None for v, ok in zip(nullable_vals, nullable_ok)]
            ),
        }
    )
    ok, out = sort_by_key(at.Int32Array.from_slice(keys), batch)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), keys[order])
    np.testing.assert_array_equal(out["w64"].raw_values(), p64[order])
    np.testing.assert_array_equal(np.asarray(out["b"].values()), pb[order])
    np.testing.assert_array_equal(out["small"].raw_values(), p16[order])
    got_nul = out["nul"].values()
    for g, v, okq in zip(got_nul, nullable_vals[order], nullable_ok[order]):
        assert (g == v) if okq else (g is None)


def test_nullable_i32_keys_stable():
    a = at.Int32Array.from_optional_slice([1, None, 3, None, 1, -2])
    assert sort(a).values() == [-2, 1, 1, 3, None, None]
    np.testing.assert_array_equal(argsort(a).raw_values(), [5, 0, 4, 2, 1, 3])


def test_argsort_stable_dupes():
    rng = np.random.default_rng(7)
    n = 2 * N - 100
    keys = rng.integers(0, 50, n).astype(np.uint32)
    order = argsort(at.UInt32Array.from_slice(keys))
    np.testing.assert_array_equal(order.raw_values(), np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("npads", [0, 1000])
def test_row_index_payload_with_max_keys(npads):
    """A row-index payload comes back as the stable order, with real
    INT32_MAX keys beside the padded tail."""
    rng = np.random.default_rng(7)
    n = 32768 - npads
    keys = rng.integers(0, 9, n).astype(np.uint32)
    keys[5] = 0x7FFFFFFF
    rows = np.arange(n, dtype=np.uint32)
    ok, orow = sort_by_key(at.UInt32Array.from_slice(keys), at.UInt32Array.from_slice(rows))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.raw_values(), keys[order])
    np.testing.assert_array_equal(orow.raw_values(), order.astype(np.uint32))


def test_row_index_payload_fuzz():
    rng = np.random.default_rng(11)
    for _ in range(4):
        n = int(rng.choice([8192, 16384, 65536]))
        dom = int(rng.choice([2, 50, 1 << 31]))
        keys = rng.integers(0, dom, n).astype(np.uint32)
        rows = np.arange(n, dtype=np.uint32)
        ok, orow = sort_by_key(at.UInt32Array.from_slice(keys), at.UInt32Array.from_slice(rows))
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(ok.raw_values(), keys[order])
        np.testing.assert_array_equal(orow.raw_values(), order.astype(np.uint32))
