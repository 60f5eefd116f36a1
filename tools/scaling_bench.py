"""N-process scaling-efficiency measurement (BASELINE.md: ">=75% rows/s
scaling efficiency at N>=2 hosts").

This measures the multi-host code path — `jax.distributed.initialize`
multi-process bring-up (`parallel/mesh.py::initialize_distributed`), a process-spanning Mesh, and the
shard_map distributed operators with their cross-process collectives — on N
single-device CPU processes over localhost.  Efficiency(P) =
rows_per_s(P) / (P * rows_per_s(1)): the fraction of perfect linear scaling
the exchange layer retains as real process boundaries (serialization, gloo
transport, collective sync) enter the path.

Usage:
    python tools/scaling_bench.py                 # P in {1,2,4,8}, writes SCALING.json
    python tools/scaling_bench.py --procs 1 2     # subset
    python tools/scaling_bench.py --rows-per-shard 65536
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(p: int, pid: int, port: int, n_per: int, iters: int) -> None:
    import numpy as np

    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")

    import arrow_tpu as at  # noqa: F401  (x64 + compile cache)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from arrow_tpu import dtypes as dt
    from arrow_tpu.parallel import distributed_ops as D
    from arrow_tpu.parallel.mesh import MeshRuntime, initialize_distributed
    from arrow_tpu.parallel.sharding import ShardedBatch, ShardedColumn

    if p > 1:  # cross-process CPU collectives ride gloo over localhost
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    initialize_distributed(f"127.0.0.1:{port}", p, pid)
    assert jax.device_count() == p, (jax.device_count(), p)
    rt = MeshRuntime.create()
    axis = rt.axis
    cap = n_per
    rng = np.random.default_rng(pid)
    keys_local = rng.integers(0, 1 << 20, cap).astype(np.uint32)
    vals_local = rng.integers(0, 100, cap).astype(np.int32)

    def gmake(local):
        dev = jax.local_devices()[0]
        shard = jax.device_put(local.reshape(1, -1), dev)
        return jax.make_array_from_single_device_arrays(
            (p, cap), NamedSharding(rt.mesh, P(axis, None)), [shard]
        )

    def gmake1(local):
        dev = jax.local_devices()[0]
        shard = jax.device_put(local, dev)
        return jax.make_array_from_single_device_arrays(
            (p,), NamedSharding(rt.mesh, P(axis)), [shard]
        )

    sb = ShardedBatch(
        {
            "k": ShardedColumn(gmake(keys_local), None, dt.ArrowType.UINT32),
            "v": ShardedColumn(gmake(vals_local), None, dt.ArrowType.INT32),
        },
        gmake1(np.full((1,), cap, np.int32)),
        rt,
    )

    results = {}

    def timed(name, fn):
        fn()  # warm (compile)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt_ = (time.perf_counter() - t0) / iters
        results[name] = {
            "rows": p * cap,
            "seconds_per_iter": dt_,
            "rows_per_s": p * cap / dt_,
        }

    def run_sort():
        out = D.distributed_sort(sb, "k", check=False)
        jax.block_until_ready(out.columns["k"].data)

    def run_agg():
        out = D.distributed_aggregate(sb, "k", [("s", "v", "sum")])
        jax.block_until_ready(out.columns["s"].data)

    def run_join():
        outs = D.distributed_join_indices(
            sb, sb, "k", "k", out_capacity=4 * cap, check=False
        )
        jax.block_until_ready(outs[0])

    timed("dist_sort", run_sort)
    timed("dist_agg", run_agg)
    timed("dist_join", run_join)

    if pid == 0:
        print("WORKER_RESULT " + json.dumps(results), flush=True)


def launch(p: int, port: int, n_per: int, iters: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    procs = []
    ncores = os.cpu_count() or 1
    for pid in range(p):
        # pin each worker to ONE core: without this the P=1 baseline's XLA
        # intra-op pool uses every host core, and "scaling efficiency" just
        # measures the loss of that extra parallelism rather than the
        # exchange layer (the target metric).  P > ncores points remain
        # oversubscribed and are reported as such.
        pin = ["taskset", "-c", str(pid % ncores)]
        procs.append(
            subprocess.Popen(
                pin + [
                    sys.executable, os.path.abspath(__file__), "--worker",
                    str(p), str(pid), str(port), str(n_per), str(iters),
                ],
                env=env,
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                text=True,
            )
        )
    out, _ = procs[0].communicate(
        timeout=int(os.environ.get("SCALING_POINT_TIMEOUT", "900"))
    )
    for q in procs[1:]:
        q.wait(timeout=60)
    for line in out.splitlines():
        if line.startswith("WORKER_RESULT "):
            return json.loads(line[len("WORKER_RESULT "):])
    raise RuntimeError(f"no result from P={p} run: {out[-2000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=5, metavar=("P", "PID", "PORT", "N", "ITERS"))
    ap.add_argument("--procs", nargs="*", type=int, default=[1, 2, 4, 8])
    # BASELINE's regime is millions of rows/shard, where a 131K-row shard
    # is dominated by fixed overhead; the sweep measures small AND large
    # shards so the report can decompose t = fixed + rows/throughput
    ap.add_argument(
        "--rows-per-shard", type=int, nargs="*", default=[131072, 4194304]
    )
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING.json"))
    args = ap.parse_args()
    if args.worker:
        p, pid, port, n, iters = map(int, args.worker)
        worker(p, pid, port, n, iters)
        return

    base_port = 12321
    report = {"sweep": {}}
    for n_per in args.rows_per_shard:
        all_results = {}
        for p in args.procs:
            t0 = time.time()
            try:
                res = launch(p, base_port + p, n_per, args.iters)
            except Exception as e:  # noqa: BLE001
                # a wedged/oversubscribed point must not kill the sweep
                # (the 2-vCPU host cannot run P=4 workers at 4M rows/shard
                # inside any reasonable wall clock)
                print(
                    f"rows/shard={n_per} P={p} FAILED: {type(e).__name__}",
                    file=sys.stderr, flush=True,
                )
                continue
            all_results[p] = res
            print(
                f"rows/shard={n_per} P={p}: "
                + "  ".join(
                    f"{k}={v['rows_per_s']/1e6:.2f} Mrows/s"
                    for k, v in res.items()
                )
                + f"  ({time.time()-t0:.0f}s)",
                file=sys.stderr, flush=True,
            )
        if not all_results:
            continue
        points = {}
        base = all_results.get(1)
        for p, res in all_results.items():
            points[str(p)] = {
                name: {
                    "rows_per_s": v["rows_per_s"],
                    "seconds_per_iter": v["seconds_per_iter"],
                    "efficiency_vs_linear": (
                        v["rows_per_s"] / (p * base[name]["rows_per_s"])
                        if base and p > 1
                        else 1.0
                    ),
                }
                for name, v in res.items()
            }
        report["sweep"][str(n_per)] = points

    # fixed-overhead vs volume decomposition: per (P, op), fit
    # t = fixed + rows_per_shard / per_shard_throughput over the two
    # smallest/largest sweep points
    sizes = sorted(int(s) for s in report["sweep"])
    if len(sizes) >= 2:
        lo, hi = sizes[0], sizes[-1]
        decomp = {}
        for p in report["sweep"][str(lo)]:
            if p not in report["sweep"][str(hi)]:
                continue
            decomp[p] = {}
            for op in report["sweep"][str(lo)][p]:
                t_lo = report["sweep"][str(lo)][p][op]["seconds_per_iter"]
                t_hi = report["sweep"][str(hi)][p][op]["seconds_per_iter"]
                slope = (t_hi - t_lo) / (hi - lo)  # s per local row
                fixed = max(t_lo - slope * lo, 0.0)
                decomp[p][op] = {
                    "fixed_s": fixed,
                    "per_mrow_s": slope * 1e6,
                    "fixed_fraction_at_small": fixed / t_lo if t_lo else 0.0,
                    "fixed_fraction_at_large": fixed / t_hi if t_hi else 0.0,
                }
        report["overhead_decomposition"] = decomp
    # headline: the large-shard efficiencies (the BASELINE regime)
    big = report["sweep"].get(str(sizes[-1]), {})
    report["rows_per_shard"] = sizes[-1]
    report["points"] = big  # back-compat shape for bench.py embedding
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(big.get("8") or big, indent=None))


if __name__ == "__main__":
    main()
