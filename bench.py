"""Benchmark harness — prints ONE JSON line.

Measures the four north-star operators (BASELINE.md) plus the elementwise tier
on the device, reporting rows/s and, on a GPU whose memory bandwidth is in
`_HBM_BYTES_PER_S`, the fraction of that bandwidth each achieves.  A run on
the CPU reports no roofline share.

Methodology (see arrow_tpu/utils/timing.py): jittable steps run K dependent
iterations inside ONE jitted fori_loop for two values of K, and the slope is
device time per iteration.  The public operators, which read a result size
back to the host, are timed as wall clock over warm repeated calls.  All
inputs are generated on the device.

Headline metric: geometric mean of the core metrics' roofline fractions.
Details go to BENCH_DETAILS.json + stderr.  The process exits non-zero when
any metric failed.

≙ the reference harness `crates/benchmarks/benches/{compare_gpu_arrow,
compare_sum}.rs` (f32 add_scalar at 10,485,760 rows; u32 sum, bytes/s) — both
mirrored here as `add_scalar_f32` and `sum_u32`.
"""

import json
import os
import sys
import time

import numpy as np


#: Peak device-memory bandwidth by `device_kind`, bytes/s (NVIDIA data
#: sheets: H100 SXM HBM3 3.35 TB/s, H100 PCIe 2.0 TB/s, H100 NVL 3.9 TB/s).
_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def _hbm_bandwidth_bytes(device_kind: str) -> float:
    """Peak memory bandwidth of a device kind; an unknown kind is an error."""
    try:
        return _HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no memory bandwidth on record for device kind {device_kind!r}"
        ) from None


# Core metrics are PRE-REGISTERED at the 1e-9 floor: a metric that crashes or
# wedges contributes ~0 to the geomean instead of silently vanishing from it.
CORE_METRICS = (
    "filter_i32_50pct",
    "sort_u32_kv",
    "hash_agg_u32_1m_keys",
    "hash_agg_u32_1k_keys",
    "hash_join_u64_full",
)
_FRACS: dict = {m: 1e-9 for m in CORE_METRICS}
_DETAILS: dict = {}


def _emit_final():
    """Write the headline JSON; failed core metrics count as the 1e-9 floor."""
    fracs = [v for v in _FRACS.values()] or [1e-9]
    headline = float(np.exp(np.mean(np.log(np.maximum(fracs, 1e-9)))))
    _DETAILS["core_geomean_roofline_frac"] = headline
    _DETAILS["metrics_completed"] = sorted(
        m for m, v in _FRACS.items() if v > 1e-9
    )
    _DETAILS["metrics_failed"] = sorted(m for m, v in _FRACS.items() if v <= 1e-9)
    with open("BENCH_DETAILS.json", "w") as f:
        json.dump(_DETAILS, f, indent=2)
    print(
        json.dumps(
            {
                "metric": "core_geomean_roofline_frac",
                "value": round(headline, 4),
                "unit": "fraction_of_hbm_roofline",
                "vs_baseline": round(headline / 0.80, 4),
            }
        ),
        flush=True,
    )


def main():
    t_start = time.time()
    import jax
    import jax.lax as lax
    import jax.numpy as jnp

    import arrow_tpu  # noqa: F401  (x64 on)
    from arrow_tpu.utils import bits as B
    from arrow_tpu.utils.scans import stable_partition
    from arrow_tpu.utils.timing import device_seconds_per_iter

    small = os.environ.get("ARROW_TPU_BENCH_SMALL", "0") == "1"
    n_elem = 1 << 20 if small else 10_485_760  # reference harness row count
    # BASELINE-scale row counts (the 100M-row filter config; sort/agg/join at
    # 128M, join 64M per side)
    n_op = 1 << (20 if small else 27)
    n_elem_big = 1 << (20 if small else 27)

    dev = jax.devices()[0]
    bw = None if dev.platform == "cpu" else _hbm_bandwidth_bytes(dev.device_kind)
    _DETAILS.update(
        {
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            },
            "hbm_bytes_per_s": bw,
            "rows": n_op,
        }
    )

    def record(name, rows, seconds, bytes_moved, core=False):
        rows_s = rows / seconds
        _DETAILS[name] = {
            "rows_per_s": rows_s,
            "seconds_per_iter": seconds,
            "algorithmic_bytes": bytes_moved,
            "gb_per_s": bytes_moved / seconds / 1e9,
        }
        roof = ""
        if bw is not None:
            frac = (bytes_moved / seconds) / bw
            _DETAILS[name]["roofline_frac"] = frac
            if core:
                _FRACS[name] = frac
            roof = f" ({frac*100:.0f}% of roofline)"
        print(
            f"{name}: {rows_s/1e9:.3f} Grows/s  {bytes_moved/seconds/1e9:.1f} GB/s"
            + roof,
            file=sys.stderr,
            flush=True,
        )

    # ---- on-device data generation ----------------------------------------
    kg = jax.random.key(0)

    import functools

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def gen_u32(key, n, hi):
        return jax.random.randint(key, (n,), 0, hi, dtype=jnp.uint32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def gen_f32(key, n):
        return jax.random.normal(key, (n,), dtype=jnp.float32)


    failed = []

    def safe(name, fn):
        """A failed metric does not stop the others; its exception lands in
        BENCH_DETAILS.json and the process exits non-zero at the end."""
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            msg = f"{type(e).__name__}: {e}"
            _DETAILS[name] = {"error": msg[:2000]}
            failed.append(name)
            print(f"{name} FAILED: {msg}", file=sys.stderr, flush=True)

    def wall_seconds(run, reps=2):
        """Wall clock per call of `run` (which must end in a host readback),
        after one warm-up call that compiles."""
        run()
        t0 = time.time()
        for _ in range(reps):
            run()
        return (time.time() - t0) / reps

    # ---- operator 1: filter (predicate + compaction) ----------------------
    # every buffer is loop-carried (returned unchanged) so nothing becomes a
    # compile-time constant that XLA would fold out of the measurement
    data = gen_u32(kg, n_op, 1 << 30).astype(jnp.int32)
    mwords = jax.jit(lambda k: B.pack_bits(jax.random.bernoulli(k, 0.5, (n_op,))))(
        jax.random.key(1)
    )

    def filter_step(y, mw):
        bools = B.unpack_bits(mw)
        count = jnp.sum(bools, dtype=jnp.uint32)
        (part,) = stable_partition(bools, [y])
        live = lax.broadcasted_iota(jnp.uint32, (n_op,), 0) < count
        return jnp.where(live, part, jnp.zeros_like(part)), mw

    safe(
        "filter_i32_50pct",
        lambda: record(
            "filter_i32_50pct",
            n_op,
            device_seconds_per_iter(filter_step, (data, mwords)),
            int(n_op * (4 + 0.125 + 2)),
            core=True,
        ),
    )

    # ---- operator 2: sort (key + payload, stable) -------------------------
    keys = gen_u32(jax.random.key(2), n_op, 1 << 31)  # noqa: E501  (data/mwords stay for the sweep below)
    payload = gen_u32(jax.random.key(3), n_op, 1 << 31)

    # the LIBRARY's sort_by_key, wall clock over warm repeated calls
    from arrow_tpu.array.array import make_array as _mk_arr
    from arrow_tpu import dtypes as _adt
    from arrow_tpu.compute.sort import sort_by_key as _sort_by_key

    def sort_full():
        ka = _mk_arr(keys, None, n_op, _adt.ArrowType.UINT32, None)
        pa = _mk_arr(payload, None, n_op, _adt.ArrowType.UINT32, None)

        def run():
            ok, _op = _sort_by_key(ka, pa)
            np.asarray(ok.data[:1])

        record("sort_u32_kv", n_op, wall_seconds(run, reps=3), n_op * 16, core=True)

    safe("sort_u32_kv", sort_full)


    # device time of the bare lax.sort (detail metric, not core)
    def sort_step(k, p):
        out = lax.sort([k, p], num_keys=1, is_stable=True)
        return out[0], out[1]

    safe(
        "sort_u32_kv_xla",
        lambda: record(
            "sort_u32_kv_xla",
            n_op,
            device_seconds_per_iter(sort_step, (keys, payload)),
            n_op * 16,
        ),
    )

    del keys, payload

    # ---- operator 3: hash aggregate (GROUP BY u32, sum+count) -------------
    # the LIBRARY's hash_aggregate, wall clock over warm repeated calls, at
    # the BASELINE key-count sweep (1K..100M distinct keys, incl. skew)
    from arrow_tpu.compute.hash_aggregate import hash_aggregate

    gvals = gen_u32(jax.random.key(5), n_op, 200).astype(jnp.int32)

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def gen_zipfish(key, n, dom):
        # heavy-hitter power-law: u^4 concentrates ~50% of rows on ~6% of keys
        u = jax.random.uniform(key, (n,), dtype=jnp.float32)
        return (u * u * u * u * dom).astype(jnp.uint32)

    def agg_time(k):
        ka = _mk_arr(k, None, n_op, _adt.ArrowType.UINT32, None)
        va = _mk_arr(gvals, None, n_op, _adt.ArrowType.INT32, None)

        def run():
            out = hash_aggregate(ka, [("s", va, "sum"), ("c", None, "count")])
            np.asarray(out["key"].data[:1])

        return wall_seconds(run)

    for name, gen, core in (
        ("hash_agg_u32_1m_keys", lambda: gen_u32(jax.random.key(4), n_op, 1 << 20), True),
        ("hash_agg_u32_1k_keys", lambda: gen_u32(jax.random.key(10), n_op, 1 << 10), True),
        ("hash_agg_u32_skew", lambda: gen_zipfish(jax.random.key(12), n_op, 1 << 20), False),
        ("hash_agg_u32_100m_keys", lambda: gen_u32(jax.random.key(13), n_op, 1 << 31), False),
    ):
        safe(
            name,
            lambda name=name, gen=gen, core=core: record(
                name, n_op, agg_time(gen()), n_op * 8, core=core
            ),
        )
    del gvals

    # ---- operator 4: hash join (u64 keys) ---------------------------------
    # u64 keys ride as 32-bit limb pairs (compute/join.py::probe_bounds)
    from arrow_tpu.compute.join import join_indices, probe_bounds

    nj = n_op // 2
    bk = gen_u32(jax.random.key(6), nj, nj).astype(jnp.uint64)
    pk = gen_u32(jax.random.key(7), nj, nj).astype(jnp.uint64)

    # CORE metric: the FULL materialized join — count, emit, build-row
    # resolution — through the library's join_indices.  join_indices
    # host-syncs the output size, so this is wall-clock over repeated warm
    # calls.
    from arrow_tpu.array.array import make_array
    from arrow_tpu import dtypes as adt

    def join_full():
        ba = make_array(bk, None, nj, adt.ArrowType.UINT64, None)
        pa = make_array(pk, None, nj, adt.ArrowType.UINT64, None)
        pi, bi, t = join_indices(ba, pa)  # warm (compiles + caches)
        jax.block_until_ready((pi.data, bi.data))
        t0 = time.time()
        reps = 2
        for _ in range(reps):
            pi, bi, _t = join_indices(ba, pa)
            jax.block_until_ready((pi.data, bi.data))
        record(
            "hash_join_u64_full",
            2 * nj,
            (time.time() - t0) / reps,
            2 * nj * 16,
            core=True,
        )
        _DETAILS["hash_join_u64_full"]["output_rows"] = int(t)

    safe("hash_join_u64_full", join_full)

    def join_step(p, b):
        ones = jnp.ones((nj,), bool)
        lo, hi = probe_bounds(b, ones, p, ones, ordered=False)
        total = jnp.sum(hi - lo, dtype=jnp.int32)
        return p ^ (total & 1).astype(jnp.uint64), b

    safe(
        "hash_join_u64_count",
        lambda: record(
            "hash_join_u64_count",
            2 * nj,
            device_seconds_per_iter(join_step, (pk, bk)),
            2 * nj * 16,
        ),
    )

    # BASELINE "skewed keys" config: heavy-hitter probe side, same executable
    pk_skew = jax.jit(
        lambda k: (
            jax.random.uniform(k, (nj,), dtype=jnp.float32) ** 4 * nj
        ).astype(jnp.uint64)
    )(jax.random.key(14))
    safe(
        "hash_join_u64_skew",
        lambda: record(
            "hash_join_u64_skew",
            2 * nj,
            device_seconds_per_iter(join_step, (pk_skew, bk)),
            2 * nj * 16,
        ),
    )

    del pk, bk, pk_skew

    # ---- reference-harness mirrors (elementwise tier) ---------------------
    xf = gen_f32(kg, n_elem)
    # in-loop timing collapses trivial elementwise chains on some AOT paths
    # and single-dispatch wall-clock measures dispatch latency; instead time a
    # host-side chain of k async dispatches (device executes them back to
    # back) and slope two chain lengths — readback reliably awaits the queue
    def queue_slope(fn, x, k_lo=8, k_hi=72):
        f = jax.jit(fn)
        y = f(x)
        np.asarray(y.ravel()[:1])  # warm compile

        def run(k):
            t0 = time.perf_counter()
            z = x
            for _ in range(k):
                z = f(z)
            np.asarray(z.ravel()[:1])
            return time.perf_counter() - t0

        ts = [(run(k_hi) - run(k_lo)) / (k_hi - k_lo) for _ in range(2)]
        return max(float(np.median(ts)), 1e-9)

    safe(
        "add_scalar_f32_10m",
        lambda: record(
            "add_scalar_f32_10m",
            n_elem,
            queue_slope(lambda y: y * 1.0001 + 1.5, xf),
            n_elem * 8,
        ),
    )

    xu = gen_u32(kg, n_elem, 1000)

    # pure reduction: carry (y, acc) so each iteration reads y ONCE and the
    # array is never re-materialized.  The xor by the FULL accumulator fuses
    # into the reduction (one read pass, nothing materialized) and is not
    # hoistable: loop-invariant code motion defeats both a plain sum(y)
    # (through the optimization barrier) and an (acc & 1)-xor whose two
    # possible operands it could precompute.  Sub-ms iterations need a large
    # K delta.
    def sum_step(y, acc):
        return y, acc + jnp.sum(y ^ acc, dtype=jnp.uint32)

    acc0 = jnp.zeros((), jnp.uint32)
    safe(
        "sum_u32_10m",
        lambda: record(
            "sum_u32_10m",
            n_elem,
            device_seconds_per_iter(sum_step, (xu, acc0), k_lo=16, k_hi=416),
            n_elem * 4,
        ),
    )

    # same two at BASELINE scale (the 10M sizes are dispatch-latency-bound)
    xf_big = gen_f32(jax.random.key(8), n_elem_big)
    safe(
        "add_scalar_f32_128m",
        lambda: record(
            "add_scalar_f32_128m",
            n_elem_big,
            queue_slope(lambda y: y * 1.0001 + 1.5, xf_big, k_lo=4, k_hi=24),
            n_elem_big * 8,
        ),
    )
    xu_big = gen_u32(jax.random.key(9), n_elem_big, 1000)
    safe(
        "sum_u32_128m",
        lambda: record(
            "sum_u32_128m",
            n_elem_big,
            device_seconds_per_iter(
                sum_step, (xu_big, acc0), k_lo=10, k_hi=110, repeats=3
            ),
            n_elem_big * 4,
        ),
    )
    del xf_big, xu_big

    # ---- full selectivity sweep (BASELINE filter config, always on) --------
    if os.environ.get("ARROW_TPU_BENCH_SWEEP", "1") == "1":
        for sel in (0.01, 0.10, 0.50, 0.90, 0.99):
            mw = jax.jit(
                lambda k, s=sel: B.pack_bits(jax.random.bernoulli(k, s, (n_op,)))
            )(jax.random.key(int(sel * 1000)))
            safe(
                f"filter_i32_sel{int(sel*100):02d}",
                lambda mw=mw, sel=sel: record(
                    f"filter_i32_sel{int(sel*100):02d}",
                    n_op,
                    device_seconds_per_iter(filter_step, (data, mw)),
                    int(n_op * (4 + 0.125 + 4 * sel)),
                ),
            )

    _DETAILS["total_bench_seconds"] = time.time() - t_start
    _emit_final()
    if failed:
        sys.exit(f"bench: metrics failed: {failed}")


if __name__ == "__main__":
    main()
