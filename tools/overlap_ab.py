"""Fused-vs-composed distributed-join A/B + per-kernel device trace.

Tests the `_fused_join_program` docstring's overlap claim: the fused program is timed against the composed
(partition, partition, join) sequence on the same mesh, and a
`jax.profiler` trace of the fused program is parsed into per-kernel device
times via `runtime.profiler.device_report`.

Modes:
  ARROW_TPU_OVERLAP_CPU=1  -> 8-virtual-device CPU mesh (collectives are
                              real HLO all-to-alls over host memory, so the
                              A/B shows scheduling effects only)
  default                  -> every visible device of the default backend
                              (up to 8); the all-to-alls run over NVLink on a
                              multi-GPU host

Results: OVERLAP_AB.json + stderr; the trace's top kernels are printed.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("ARROW_TPU_OVERLAP_CPU") == "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np

import arrow_tpu as at  # noqa: F401
from arrow_tpu import parallel as PP
from arrow_tpu.runtime import profiler
from arrow_tpu.table import RecordBatch


def main():
    ndev = len(jax.devices())
    p = 8 if os.environ.get("ARROW_TPU_OVERLAP_CPU") == "1" else min(ndev, 8)
    rt = PP.MeshRuntime.create(num_devices=p)
    rng = np.random.default_rng(3)
    n = 1 << 16 if jax.default_backend() == "cpu" else 1 << 20
    bk = rng.integers(0, n, n).astype(np.uint64)
    pk = rng.integers(0, n, n).astype(np.uint64)
    bv = np.arange(n, dtype=np.int32)
    pv = np.arange(n, dtype=np.int32)
    sb = PP.shard_batch(RecordBatch.from_numpy({"k": bk, "v": bv}), rt)
    sp = PP.shard_batch(RecordBatch.from_numpy({"k": pk, "w": pv}), rt)

    def run(fused):
        return PP.distributed_join(sb, sp, "k", "k", fused=fused)

    out = {"mesh_devices": p, "backend": jax.default_backend(), "rows_per_side": n}
    for fused in (True, False):
        r = run(fused)  # warm/compile
        jax.block_until_ready([c.data for c in r.columns.values()])
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            r = run(fused)
            jax.block_until_ready([c.data for c in r.columns.values()])
        out["fused_s" if fused else "composed_s"] = (time.perf_counter() - t0) / reps
    out["fused_speedup"] = out["composed_s"] / out["fused_s"]

    rows = profiler.device_report(lambda: run(True))
    out["top_kernels"] = [(nm, c, round(ms, 3)) for nm, c, ms in rows[:15]]
    print(profiler.device_summary(rows[:15]), file=sys.stderr)
    print(
        f"fused {out['fused_s']*1e3:.1f} ms vs composed {out['composed_s']*1e3:.1f} ms "
        f"(x{out['fused_speedup']:.2f})",
        file=sys.stderr,
    )
    name = (
        "OVERLAP_AB_CPU.json"
        if os.environ.get("ARROW_TPU_OVERLAP_CPU") == "1"
        else "OVERLAP_AB.json"
    )
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), name), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels"}))


if __name__ == "__main__":
    main()
