"""Distributed tier tests on an 8-virtual-device CPU mesh (conftest forces
--xla_force_host_platform_device_count=8, the analog of the reference's
software-Vulkan CI trick)."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import parallel as PP
from arrow_tpu.table import RecordBatch

import jax


@pytest.fixture(scope="module")
def rt():
    assert jax.device_count() >= 8, "conftest must provide 8 cpu devices"
    return PP.MeshRuntime.create(num_devices=8)


def _batch(n=10_000, seed=0, with_nulls=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 500, n).astype(np.uint32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    rb = RecordBatch.from_numpy({"k": keys, "v": vals})
    if with_nulls:
        kcol = at.UInt32Array.from_optional_slice(
            [None if i % 7 == 0 else int(k) for i, k in enumerate(keys)]
        )
        rb = rb.with_column("k", kcol)
    return rb, keys, vals


def test_shard_roundtrip(rt):
    rb, keys, vals = _batch(5000)
    sb = PP.shard_batch(rb, rt)
    assert sb.num_shards == 8
    assert sb.num_rows() == 5000
    back = PP.gather_batch(sb)
    np.testing.assert_array_equal(back["k"].raw_values(), keys)
    np.testing.assert_array_equal(back["v"].raw_values(), vals)


def test_shard_roundtrip_with_nulls_and_bool(rt):
    rb = RecordBatch(
        {
            "x": at.Int32Array.from_optional_slice([1, None, 3, 4, None, 6, 7, 8, 9, 10]),
            "b": at.BooleanArray.from_slice([True, False] * 5),
        }
    )
    sb = PP.shard_batch(rb, rt)
    back = PP.gather_batch(sb)
    assert back["x"].values() == [1, None, 3, 4, None, 6, 7, 8, 9, 10]
    assert back["b"].values() == [True, False] * 5


def test_hash_partition_places_equal_keys_together(rt):
    rb, keys, vals = _batch(20_000, seed=1)
    sb = PP.shard_batch(rb, rt)
    shuffled = PP.hash_partition(sb, "k")
    assert shuffled.num_rows() == 20_000
    # every key must live on exactly the shard hash(key) % 8
    back_counts = np.asarray(shuffled.counts)
    data = np.asarray(shuffled["k"].data)
    for s in range(8):
        ks = data[s, : back_counts[s]]
        if ks.size:
            import jax.numpy as jnp

            h = np.asarray(PP.hash_key(jnp.asarray(ks))) % 8
            assert (h == s).all()
    # multiset of (k, v) rows preserved
    vdata = np.asarray(shuffled["v"].data)
    got = []
    for s in range(8):
        got += list(zip(data[s, : back_counts[s]], vdata[s, : back_counts[s]]))
    assert sorted(got) == sorted(zip(keys.tolist(), vals.tolist()))


def test_distributed_sum(rt):
    rb, keys, vals = _batch(30_000, seed=2)
    sb = PP.shard_batch(rb, rt)
    total = int(PP.distributed_sum(sb, "v"))
    assert total == int(vals.sum())


def test_distributed_filter(rt):
    rng = np.random.default_rng(5)
    n = 8000
    vals = rng.integers(0, 100, n).astype(np.int32)
    keep = vals % 2 == 0
    rb = RecordBatch(
        {
            "v": at.Int32Array.from_slice(vals),
            "m": at.BooleanArray.from_slice(keep),
        }
    )
    sb = PP.shard_batch(rb, rt)
    out = PP.distributed_filter(sb, "m")
    assert out.num_rows() == int(keep.sum())
    back = PP.gather_batch(out)
    np.testing.assert_array_equal(back["v"].raw_values(), vals[keep])


def test_distributed_aggregate(rt):
    rb, keys, vals = _batch(40_000, seed=3)
    sb = PP.shard_batch(rb, rt)
    out = PP.distributed_aggregate(
        sb, "k", [("s", "v", "sum"), ("c", None, "count"), ("mx", "v", "max")]
    )
    back = PP.gather_batch(out)
    got = sorted(
        zip(back["key"].raw_values().tolist(), back["s"].raw_values().tolist(),
            back["c"].raw_values().tolist(), back["mx"].raw_values().tolist())
    )
    uk = np.unique(keys)
    sums = np.zeros(uk.shape[0], np.int64)
    np.add.at(sums, np.searchsorted(uk, keys), vals)
    counts = np.bincount(np.searchsorted(uk, keys))
    maxs = np.full(uk.shape[0], -(2**31), np.int64)
    np.maximum.at(maxs, np.searchsorted(uk, keys), vals)
    expected = sorted(
        zip(uk.tolist(), sums.astype(np.int32).tolist(), counts.tolist(), maxs.tolist())
    )
    assert got == expected


def test_distributed_join(rt):
    rng = np.random.default_rng(9)
    nb, np_ = 4000, 6000
    bk = rng.integers(0, 2000, nb).astype(np.uint64)
    pk = rng.integers(0, 2000, np_).astype(np.uint64)
    build = PP.shard_batch(RecordBatch.from_numpy({"k": bk}), rt)
    probe = PP.shard_batch(RecordBatch.from_numpy({"k": pk}), rt)
    counts, pidx, bidx, pb, pp_ = PP.distributed_join_indices(
        build, probe, "k", "k", out_capacity=64 * 1024
    )
    total = int(np.asarray(counts).sum())
    cnt_b = np.bincount(bk.astype(np.int64), minlength=2000)
    expected = int(cnt_b[pk.astype(np.int64)].sum())
    assert total == expected
    # verify matches key-by-key
    c = np.asarray(counts)
    pi = np.asarray(pidx.data)
    bi = np.asarray(bidx.data)
    bkd = np.asarray(pb["k"].data)
    pkd = np.asarray(pp_["k"].data)
    for s in range(8):
        k = int(c[s])
        np.testing.assert_array_equal(pkd[s][pi[s, :k]], bkd[s][bi[s, :k]])


def test_distributed_sort(rt):
    rng = np.random.default_rng(13)
    n = 30_000
    keys = rng.integers(0, 1 << 31, n).astype(np.uint32)
    payload = np.arange(n, dtype=np.int32)
    rb = RecordBatch.from_numpy({"k": keys, "p": payload})
    sb = PP.shard_batch(rb, rt)
    out = PP.distributed_sort(sb, "k")
    assert out.num_rows() == n
    back = PP.gather_batch(out)
    got_k = np.asarray(back["k"].raw_values())
    np.testing.assert_array_equal(got_k, np.sort(keys))
    # payload rode along: multiset of (k, p) preserved
    got_p = np.asarray(back["p"].raw_values())
    assert sorted(zip(got_k.tolist(), got_p.tolist())) == sorted(
        zip(keys.tolist(), payload.tolist())
    )


def test_skewed_shuffle_default_auto_retry(rt):
    """Skew-safe sizing is the DEFAULT — an all-one-shard
    distribution under default arguments must succeed via the automatic
    full-bucket retry, not raise; and the first-attempt send tensor must be
    histogram-bounded (O(cap * 4), not O(P * cap))."""
    n = 16_000
    rb = RecordBatch.from_numpy({"k": np.full(n, 77, np.uint32)})
    sb = PP.shard_batch(rb, rt)
    p = rt.num_shards
    default_bucket = min(sb.capacity, max(1024, -(-sb.capacity // p) * 4))
    if p >= 8:
        # memory assertion: default send tensor is p*bucket <= cap*4 rows,
        # far below the p*cap worst case
        assert p * default_bucket <= 4 * sb.capacity + p * 1024
    out = PP.hash_partition(sb, "k", out_capacity=16 * 1024)
    assert out.num_rows() == n


def test_skewed_shuffle_overflow_detection(rt):
    # all rows hash to one shard -> default bucket must overflow and raise
    n = 16_000
    rb = RecordBatch.from_numpy({"k": np.full(n, 77, np.uint32)})
    sb = PP.shard_batch(rb, rt)
    with pytest.raises(at.ArrowTpuError):
        PP.hash_partition(sb, "k", bucket_rows=1024, out_capacity=1024)
    # with enough slack it succeeds
    out = PP.hash_partition(sb, "k", bucket_rows=sb.capacity, out_capacity=16 * 1024)
    assert out.num_rows() == n


def test_distributed_join_payload(rt):
    rng = np.random.default_rng(21)
    left = PP.shard_batch(
        RecordBatch.from_numpy(
            {"k": rng.integers(0, 500, 3000).astype(np.uint64),
             "lv": np.arange(3000, dtype=np.int32)}
        ),
        rt,
    )
    right = PP.shard_batch(
        RecordBatch.from_numpy(
            {"k": np.arange(500, dtype=np.uint64),
             "rv": (np.arange(500) * 10).astype(np.int32)}
        ),
        rt,
    )
    out = PP.distributed_join(left, right, "k", "k", out_capacity=16 * 1024)
    back = PP.gather_batch(out)
    ks = np.asarray(back["k"].raw_values())
    rvs = np.asarray(back["rv"].raw_values())
    lvs = np.asarray(back["lv"].raw_values())
    assert out.num_rows() == 3000  # unique build keys -> one match per probe row
    np.testing.assert_array_equal(rvs, ks * 10)
    # every (k, lv) pair of the left table appears exactly once
    assert sorted(zip(ks.tolist(), lvs.tolist())) == sorted(
        zip(np.asarray(PP.gather_batch(left)["k"].raw_values()).tolist(),
            np.asarray(PP.gather_batch(left)["lv"].raw_values()).tolist())
    )


def test_distributed_aggregate_no_preagg_matches(rt):
    rb, keys, vals = _batch(20_000, seed=31)
    sb = PP.shard_batch(rb, rt)
    a1 = PP.gather_batch(PP.distributed_aggregate(sb, "k", [("s", "v", "sum")]))
    a2 = PP.gather_batch(
        PP.distributed_aggregate(sb, "k", [("s", "v", "sum")], pre_aggregate=False)
    )
    assert sorted(zip(a1["key"].values(), a1["s"].values())) == sorted(
        zip(a2["key"].values(), a2["s"].values())
    )


def test_distributed_aggregate_extreme_skew(rt):
    # one key owns 95% of rows: pre-aggregation keeps the shuffle balanced
    n = 40_000
    keys = np.where(np.random.default_rng(5).random(n) < 0.95, 7, 13).astype(np.uint32)
    vals = np.ones(n, np.int32)
    sb = PP.shard_batch(RecordBatch.from_numpy({"k": keys, "v": vals}), rt)
    out = PP.gather_batch(
        PP.distributed_aggregate(sb, "k", [("c", "v", "sum")], bucket_rows=1024)
    )
    got = dict(zip(out["key"].values(), out["c"].values()))
    assert got[7] == int((keys == 7).sum())
    assert got[13] == int((keys == 13).sum())


def test_distributed_join_fused_matches_unfused(rt):
    rng = np.random.default_rng(33)
    left = PP.shard_batch(
        RecordBatch.from_numpy(
            {"k": rng.integers(0, 300, 2500).astype(np.uint64),
             "lv": rng.integers(0, 10**6, 2500).astype(np.int32)}
        ),
        rt,
    )
    right = PP.shard_batch(
        RecordBatch.from_numpy(
            {"k": rng.integers(0, 300, 1500).astype(np.uint64),
             "rv": rng.integers(0, 10**6, 1500).astype(np.int32)}
        ),
        rt,
    )
    f = PP.gather_batch(PP.distributed_join(left, right, "k", "k", out_capacity=64 * 1024, fused=True))
    u = PP.gather_batch(PP.distributed_join(left, right, "k", "k", out_capacity=64 * 1024, fused=False))
    rows_f = sorted(zip(f["k"].values(), f["lv"].values(), f["rv"].values()))
    rows_u = sorted(zip(u["k"].values(), u["lv"].values(), u["rv"].values()))
    assert rows_f == rows_u and len(rows_f) > 0


def test_shuffle_and_sort_sub32bit_columns(rt):
    """The fused u32-plane exchange must carry sub-32-bit
    columns (astype widening, not bitcast — bitcast raises on width change)."""
    rng = np.random.default_rng(12)
    n = 4000
    keys = rng.integers(0, 100, n).astype(np.uint32)
    small = rng.integers(-128, 127, n).astype(np.int16)
    tiny = rng.integers(0, 255, n).astype(np.uint8)
    rb = RecordBatch(
        {
            "k": at.UInt32Array.from_slice(keys),
            "s": at.Int16Array.from_slice(small),
            "t": at.UInt8Array.from_slice(tiny),
        }
    )
    sb = PP.shard_batch(rb, rt)
    shuffled = PP.hash_partition(sb, "k")
    back = PP.gather_batch(shuffled)
    got = sorted(zip(back["k"].raw_values(), back["s"].raw_values(), back["t"].raw_values()))
    exp = sorted(zip(keys.tolist(), small.tolist(), tiny.tolist()))
    assert got == exp

    out = PP.distributed_sort(sb, "k")
    kb = np.asarray(PP.gather_batch(out)["k"].raw_values())
    np.testing.assert_array_equal(kb, np.sort(keys))


def test_distributed_sort_all_equal_keys(rt):
    """The default send bucket must hold ANY distribution
    (all rows routed to one destination must not overflow or truncate)."""
    n = 4096
    keys = np.full(n, 7, np.uint32)
    vals = np.arange(n, dtype=np.int32)
    rb = RecordBatch.from_numpy({"k": keys, "v": vals})
    sb = PP.shard_batch(rb, rt)
    out = PP.distributed_sort(sb, "k")
    assert out.num_rows() == n
    back = PP.gather_batch(out)
    np.testing.assert_array_equal(np.asarray(back["k"].raw_values()), keys)
