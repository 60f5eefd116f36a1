"""End-to-end smoke run of the engine on GPUs, checked against numpy.

    python chip_smoke.py [--seed N]        # one GPU: five phases of the main path
    python chip_smoke.py --chips 4         # four GPUs: the distributed tier only

One GPU runs five phases through the public API: `elementwise` (scalar add,
sum, a three-op ComputePipeline), `query` (predicate, filter, group-by),
`groupby_dense`, `sort` and `join`.  Four GPUs run the distributed tier
(shard, filter, hash partition, aggregate, join, sort, gather) on a 1-D mesh.
Data comes from numpy's generator seeded with --seed.

Each phase calls its operators twice and prints the first call's time
(compile included), the second call's time from the Python call until every
output buffer is ready, rows/s of the second call, the device's
`peak_bytes_in_use` so far, and each check's largest error beside its
tolerance.  Every result is compared with a plain numpy reference of the same
semantics.

The run fails (non-zero exit, no JSON line) when JAX finds no GPU or fewer
GPUs than asked for, when a phase raises, or when a check fails.  The last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Row counts.  `ELEMENTWISE_ROWS` is the reference harness's own size
#: (`crates/benchmarks`, f32 add_scalar and u32 sum at 10,485,760 rows); the
#: operator sizes are BASELINE's configurations cut to 2^26-2^27 rows so the
#: host numpy reference finishes in seconds.
ELEMENTWISE_ROWS = 10_485_760
QUERY_ROWS = 1 << 27
QUERY_KEYS = 1 << 20
GROUPBY_ROWS = 1 << 27
GROUPBY_KEYS = 1000
SORT_ROWS = 1 << 27
SORT_I64_ROWS = 1 << 26
JOIN_ROWS = 1 << 26
DIST_ROWS_PER_CARD = 1 << 25

#: Relative tolerance of f32 group sums against a float64 reference: the
#: segmented scan adds in another order than numpy.
SUM_RTOL = 1e-4


class CheckFailed(AssertionError):
    """A phase's result disagrees with the numpy reference."""


class Checks:
    """Largest error of each named check, beside its tolerance."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def exact(self, name, got, want):
        """Count of elements that differ bit for bit (tolerance 0)."""
        got = np.asarray(got)
        want = np.asarray(want, dtype=got.dtype)
        if got.shape != want.shape:
            raise CheckFailed(f"{name}: shape {got.shape} != expected {want.shape}")
        if got.dtype.kind == "f":
            bits = np.dtype(f"u{got.dtype.itemsize}")
            got, want = got.view(bits), want.view(bits)
        self._add(name, int(np.count_nonzero(got != want)), 0)

    def equal(self, name, got, want):
        """|got - want| for two scalars (tolerance 0)."""
        self._add(name, abs(int(got) - int(want)), 0)

    def rel(self, name, got, want, tol):
        """Largest |got - want| / |want| over the elements."""
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise CheckFailed(f"{name}: shape {got.shape} != expected {want.shape}")
        err = float(np.max(np.abs(got - want) / np.abs(want))) if want.size else 0.0
        self._add(name, err, tol)

    def _add(self, name, err, tol):
        self.items.append((name, err, tol))
        if not err <= tol:
            raise CheckFailed(f"{name}: error {err} exceeds tolerance {tol}")

    def __str__(self):
        return ", ".join(f"{n}={e:.3g} (tol {t:g})" for n, e, t in self.items)


def _buffers(out):
    """Device buffers of a result: arrays, (sharded) batches, tuples of them."""
    from arrow_tpu.parallel import ShardedBatch
    from arrow_tpu.table import RecordBatch

    if isinstance(out, (tuple, list)):
        return [b for o in out for b in _buffers(o)]
    if isinstance(out, RecordBatch):
        return _buffers(list(out.columns().values()))
    if isinstance(out, ShardedBatch):
        return _buffers(list(out.columns.values())) + [out.counts]
    if hasattr(out, "data"):  # an array or a sharded column
        return [b for b in (out.data, out.validity) if b is not None]
    return [out]


def _ready(*outs):
    import jax

    jax.block_until_ready(_buffers(outs))


def _twice(fn):
    """Run `fn` twice; returns (second result, first seconds, second seconds)."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    second = time.perf_counter() - t0
    return out, first, second


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _report(name, rows, first, second, checks):
    print(
        f"[{name}] rows={rows} first_call_s={first:.4f} second_call_s={second:.4f} "
        f"rows_per_s={rows / second:.4g} peak_bytes_in_use={_peak_bytes()} "
        f"checks: {checks}",
        flush=True,
    )


def _values(arr):
    """Host copy of a column's logical rows."""
    return np.asarray(arr.data)[: len(arr)]


# --------------------------------------------------------------------- phases


def phase_elementwise(rng, n=ELEMENTWISE_ROWS):
    import arrow_tpu as at
    from arrow_tpu import kernels as K
    from arrow_tpu.ops.aggregate import sum_

    x = rng.standard_normal(n, dtype=np.float32)
    y = rng.standard_normal(n, dtype=np.float32)
    u = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    xa, ya = at.Float32Array.from_slice(x), at.Float32Array.from_slice(y)
    ua = at.UInt32Array.from_slice(u)

    def run():
        added = K.add_scalar(xa, 1.5)
        total = sum_(ua)
        with at.ComputePipeline() as p:
            r1 = K.add_op(xa, ya, p)
            r2 = K.add_scalar_op(r1, 1.5, p)
            r3 = K.mul_scalar_op(r2, 2.0, p)
        _ready(added, total, r3)
        return added, total, r3

    (added, total, chained), first, second = _twice(run)
    c = Checks()
    c.exact("add_scalar_f32", _values(added), x + np.float32(1.5))
    c.exact("sum_u32", _values(total), np.array([np.sum(u, dtype=np.uint32)]))
    c.exact("pipeline_f32", _values(chained), ((x + y) + np.float32(1.5)) * np.float32(2.0))
    _report("elementwise", n, first, second, c)
    return c


def _nullable_f32(values, valid):
    import arrow_tpu as at

    words = at.BooleanArray.from_slice(valid).data
    return at.Float32Array.from_jax(
        at.Float32Array.from_slice(values).data, len(values), validity=words
    )


def phase_query(rng, n=QUERY_ROWS, n_keys=QUERY_KEYS):
    import arrow_tpu as at
    from arrow_tpu import compute as C
    from arrow_tpu import kernels as K
    from arrow_tpu.table import RecordBatch

    k = rng.integers(0, n_keys, n, dtype=np.uint32)
    v = rng.standard_normal(n, dtype=np.float32)
    valid = rng.integers(0, 100, n, dtype=np.uint8) != 0  # 1% nulls
    v[~valid] = 0.0
    batch = RecordBatch({"k": at.UInt32Array.from_slice(k), "v": _nullable_f32(v, valid)})

    def run():
        kept = C.filter(batch, K.gt_scalar(batch["v"], 0.0))
        agg = C.hash_aggregate(kept["k"], [("s", kept["v"], "sum"), ("n", None, "count")])
        _ready(agg)
        return kept, agg

    (kept, agg), first, second = _twice(run)
    sel = valid & (v > 0)
    ks = k[sel]
    counts = np.bincount(ks, minlength=n_keys)
    sums = np.bincount(ks, weights=v[sel].astype(np.float64), minlength=n_keys)
    groups = np.flatnonzero(counts)
    c = Checks()
    c.equal("kept_rows", kept.num_rows, int(sel.sum()))
    c.exact("keys", _values(agg["key"]), groups.astype(np.uint32))
    c.exact("counts", _values(agg["n"]), counts[groups])
    c.rel("sum_rel", _values(agg["s"]), sums[groups], SUM_RTOL)
    _report("query", n, first, second, c)
    return c


def phase_groupby_dense(rng, n=GROUPBY_ROWS, n_keys=GROUPBY_KEYS):
    import arrow_tpu as at
    from arrow_tpu import compute as C

    k = rng.integers(0, n_keys, n, dtype=np.uint32)
    v = rng.integers(-1000, 1000, n, dtype=np.int32)
    ka, va = at.UInt32Array.from_slice(k), at.Int32Array.from_slice(v)
    aggs = [("s", va, "sum"), ("n", None, "count"), ("lo", va, "min"), ("hi", va, "max")]

    def run():
        agg = C.hash_aggregate(ka, aggs)
        _ready(agg)
        return agg

    agg, first, second = _twice(run)
    counts = np.bincount(k, minlength=n_keys)
    groups = np.flatnonzero(counts)
    # float64 weights are exact here: every partial sum stays below 2^53
    sums = np.bincount(k, weights=v, minlength=n_keys).astype(np.int64)
    lo =np.full(n_keys, np.iinfo(np.int32).max, np.int32)
    np.minimum.at(lo, k, v)
    hi = np.full(n_keys, np.iinfo(np.int32).min, np.int32)
    np.maximum.at(hi, k, v)
    c = Checks()
    c.exact("keys", _values(agg["key"]), groups.astype(np.uint32))
    c.exact("counts", _values(agg["n"]), counts[groups])
    c.exact("sums", _values(agg["s"]), sums[groups].astype(np.int32))
    c.exact("mins", _values(agg["lo"]), lo[groups])
    c.exact("maxs", _values(agg["hi"]), hi[groups])
    _report("groupby_dense", n, first, second, c)
    return c


def phase_sort(rng, n=SORT_ROWS, n_i64=SORT_I64_ROWS):
    import arrow_tpu as at
    from arrow_tpu import compute as C

    k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    p = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    w = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n_i64, dtype=np.int64)
    ka, pa = at.UInt32Array.from_slice(k), at.UInt32Array.from_slice(p)
    wa = at.Int64Array.from_slice(w)

    def run():
        sk, sp = C.sort_by_key(ka, pa)
        sw = C.sort(wa)
        _ready(sk, sp, sw)
        return sk, sp, sw

    (sk, sp, sw), first, second = _twice(run)
    order = np.argsort(k, kind="stable")
    c = Checks()
    c.exact("u32_keys", _values(sk), k[order])
    c.exact("u32_payload", _values(sp), p[order])
    c.exact("i64_keys", _values(sw), np.sort(w, kind="stable"))
    _report("sort", n + n_i64, first, second, c)
    return c


def _join_keys(x):
    """Spread small ids over the whole u64 range (an odd multiplier is a
    bijection mod 2^64), so both 32-bit halves of the key matter."""
    return x.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)


def join_reference(bk, pk):
    """(probe row, build row) pairs of an inner equi-join, ordered by probe
    row then build row."""
    order = np.argsort(bk, kind="stable")
    sbk = bk[order]
    lo = np.searchsorted(sbk, pk, side="left")
    cnt = np.searchsorted(sbk, pk, side="right") - lo
    total = int(cnt.sum())
    starts = np.cumsum(cnt) - cnt
    within = np.arange(total) - np.repeat(starts, cnt)
    probe = np.repeat(np.arange(pk.shape[0]), cnt)
    build = order[np.repeat(lo, cnt) + within]
    return probe, build


def phase_join(rng, n=JOIN_ROWS):
    import arrow_tpu as at
    from arrow_tpu import compute as C
    from arrow_tpu.table import RecordBatch

    domain = n // 2  # about two build rows per key
    bx = rng.integers(0, domain, n)
    # half the probes take a build row's key, half a key no build row has
    px = np.where(
        rng.integers(0, 2, n, dtype=np.uint8) == 1,
        bx[rng.integers(0, n, n)],
        rng.integers(domain, 2 * domain, n),
    )
    bk, pk = _join_keys(bx), _join_keys(px)
    rows = np.arange(n, dtype=np.uint32)
    build = RecordBatch({"k": at.UInt64Array.from_slice(bk), "b": at.UInt32Array.from_slice(rows)})
    probe = RecordBatch({"k": at.UInt64Array.from_slice(pk), "p": at.UInt32Array.from_slice(rows)})

    def run():
        out = C.hash_join(probe, build, "k", "k")
        _ready(out)
        return out

    out, first, second = _twice(run)
    want_p, want_b = join_reference(bk, pk)
    got = (_values(out["p"]).astype(np.uint64) << np.uint64(32)) | _values(out["b"])
    if got.size > 1 and not np.all(got[1:] >= got[:-1]):
        got = np.sort(got)
    want = (want_p.astype(np.uint64) << np.uint64(32)) | want_b.astype(np.uint64)
    c = Checks()
    c.equal("matches", out.num_rows, want.size)
    c.exact("pairs", got, want)
    c.exact("keys", _values(out["k"]), pk[want_p])
    _report("join", 2 * n, first, second, c)
    return c


PHASES = (phase_elementwise, phase_query, phase_groupby_dense, phase_sort, phase_join)


def phase_distributed(rng, n_devices, rows_per_card=DIST_ROWS_PER_CARD, n_keys=1 << 20):
    """The distributed tier on a 1-D mesh over `n_devices` devices."""
    import jax

    import arrow_tpu as at
    from arrow_tpu import parallel as PP
    from arrow_tpu.table import RecordBatch

    rt = PP.MeshRuntime.create(num_devices=n_devices)
    n = rows_per_card * n_devices
    keys = rng.integers(0, n_keys, n, dtype=np.uint32)
    vals = rng.integers(-1000, 1000, n, dtype=np.int32)
    mask = rng.integers(0, 2, n, dtype=np.uint8) == 1
    rb = RecordBatch(
        {
            "k": at.UInt32Array.from_slice(keys),
            "v": at.Int32Array.from_slice(vals),
            "m": at.BooleanArray.from_slice(mask),
        }
    )
    t0 = time.perf_counter()
    sb = PP.shard_batch(rb, rt)
    jax.block_until_ready(sb.counts)
    shard_s = time.perf_counter() - t0
    table = PP.ShardedBatch({"k": sb["k"], "v": sb["v"]}, sb.counts, rt)

    steps = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _ready(out)
        steps.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def run():
        filtered = step("distributed_filter", lambda: PP.distributed_filter(sb, "m"))
        parted = step("hash_partition", lambda: PP.hash_partition(filtered, "k"))
        agg = step(
            "distributed_aggregate",
            lambda: PP.distributed_aggregate(
                filtered, "k", [("s", "v", "sum"), ("c", None, "count")]
            ),
        )
        groups = PP.ShardedBatch({"k": agg["key"]}, agg.counts, rt)
        joined = step(
            "distributed_join_indices",
            lambda: PP.distributed_join_indices(groups, table, "k", "k"),
        )
        plain = PP.ShardedBatch({"k": filtered["k"], "v": filtered["v"]}, filtered.counts, rt)
        ordered = step("distributed_sort", lambda: PP.distributed_sort(plain, "k"))
        return filtered, parted, agg, joined, ordered

    run()
    filtered, parted, agg, joined, ordered = run()
    t0 = time.perf_counter()
    back = {name: PP.gather_batch(sb_) for name, sb_ in
            (("filtered", filtered), ("parted", parted), ("agg", agg), ("ordered", ordered))}
    gather_s = time.perf_counter() - t0

    def pair(k, v):
        return np.sort((k.astype(np.uint64) << np.uint64(32)) | v.astype(np.uint32))

    c = Checks()
    fk, fv = keys[mask], vals[mask]
    c.exact("filter_k", _values(back["filtered"]["k"]), fk)
    c.exact("filter_v", _values(back["filtered"]["v"]), fv)

    c.exact("partition_rows", pair(_values(back["parted"]["k"]), _values(back["parted"]["v"])), pair(fk, fv))
    pcounts = np.asarray(parted.counts)
    pkeys = np.asarray(parted["k"].data)
    shard_keys = np.concatenate([np.unique(pkeys[s, : pcounts[s]]) for s in range(n_devices)])
    c.equal("keys_on_two_shards", shard_keys.size - np.unique(shard_keys).size, 0)

    counts = np.bincount(fk, minlength=n_keys)
    sums = np.bincount(fk, weights=fv.astype(np.float64), minlength=n_keys).astype(np.int64)
    groups = np.flatnonzero(counts)
    ak = _values(back["agg"]["key"])
    order = np.argsort(ak)
    c.exact("agg_keys", ak[order], groups.astype(np.uint32))
    c.exact("agg_sums", _values(back["agg"]["s"])[order], sums[groups].astype(np.int32))
    c.exact("agg_counts", _values(back["agg"]["c"])[order], counts[groups])

    jcounts, pidx, bidx, jbuild, jprobe = joined
    jcounts = np.asarray(jcounts)
    hit = counts[keys] > 0  # rows of the whole table whose key survives the filter
    c.equal("join_matches", int(jcounts.sum()), int(hit.sum()))
    bkeys, pk_all = np.asarray(jbuild["k"].data), np.asarray(jprobe["k"].data)
    pv_all = np.asarray(jprobe["v"].data)
    pi_all, bi_all = np.asarray(pidx.data), np.asarray(bidx.data)
    mk, mv, key_diff, repeats = [], [], 0, 0
    for s in range(n_devices):
        pi, bi = pi_all[s, : jcounts[s]], bi_all[s, : jcounts[s]]
        key_diff += int(np.count_nonzero(bkeys[s][bi] != pk_all[s][pi]))
        repeats += pi.size - np.unique(pi).size
        mk.append(pk_all[s][pi])
        mv.append(pv_all[s][pi])
    c.equal("join_key_mismatch", key_diff, 0)
    c.equal("join_probe_repeats", repeats, 0)
    c.exact("join_pairs", pair(np.concatenate(mk), np.concatenate(mv)), pair(keys[hit], vals[hit]))

    ok_ = _values(back["ordered"]["k"])
    c.exact("sort_keys", ok_, np.sort(fk))
    c.exact("sort_rows", pair(ok_, _values(back["ordered"]["v"])), pair(fk, fv))

    for name, (t_first, t_second) in steps.items():
        print(f"[{name}] rows={n} first_call_s={t_first:.4f} second_call_s={t_second:.4f} "
              f"rows_per_s={n / t_second:.4g}", flush=True)
    print(f"[distributed] devices={n_devices} rows={n} shard_batch_s={shard_s:.4f} "
          f"gather_batch_s={gather_s:.4f} peak_bytes_in_use={_peak_bytes()} checks: {c}",
          flush=True)
    return c


# ----------------------------------------------------------------------- main


def build_native():
    """Build the C++ host runtime for this machine (set-up time)."""
    t0 = time.perf_counter()
    subprocess.run(["make", "-s", "-B", "-C", os.path.join(REPO, "csrc")], check=True)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the distributed tier, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default backend: {backend})")
    devices = jax.devices()
    if len(devices) < args.chips:
        sys.exit(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, {len(devices)} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax.devices(): {devices}", flush=True)

    native_s = build_native()
    import arrow_tpu  # noqa: F401  (x64, compile cache)
    from arrow_tpu.runtime import native

    print(f"setup: native host runtime built in {native_s:.2f}s, "
          f"loaded={native.have_native()}", flush=True)

    if args.chips == 1:
        for i, phase in enumerate(PHASES):
            phase(np.random.default_rng([args.seed, i]))
    else:
        phase_distributed(np.random.default_rng([args.seed, 100]), args.chips)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
