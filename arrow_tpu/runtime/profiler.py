"""Per-op profiling (≙ the reference's ``CmpQuery`` GPU timestamp queries,
`crates/array/src/gpu_utils/compute_query.rs`, behind its
`profile` cargo feature).

The analog of per-pass timestamp queries is wall-clock timing around
``block_until_ready`` plus `jax.profiler` traces for intra-program detail.
Enable with ARROW_TPU_PROFILE=1 or ``config.profile = True``; timings accumulate
in a process-wide log (the reference logs ms per pass, `compute_query.rs:71-74`).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, List

import jax

from ..config import config

log = logging.getLogger("arrow_tpu")

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


def record(name: str, seconds: float) -> None:
    _TIMINGS[name].append(seconds)
    log.debug("arrow_tpu profile: %s took %.3f ms", name, seconds * 1e3)


@contextlib.contextmanager
def profile_region(name: str):
    """Time a region to completion (blocks on outstanding work at exit)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def timed_call(name: str, fn, *args):
    """Run fn, blocking until device completion, and record the wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    record(name, time.perf_counter() - t0)
    return out


def timings() -> Dict[str, List[float]]:
    return dict(_TIMINGS)


def reset() -> None:
    _TIMINGS.clear()


def summary() -> str:
    lines = []
    for name, ts in sorted(_TIMINGS.items()):
        total = sum(ts)
        lines.append(
            f"{name:32s} calls={len(ts):5d} total={total*1e3:9.2f}ms "
            f"mean={total/len(ts)*1e3:8.3f}ms"
        )
    return "\n".join(lines)


# -- per-kernel device time (≙ CmpQuery timestamp queries) -------------------


def device_report(fn, *args, top: int = 25, logdir: str | None = None):
    """Run ``fn(*args)`` once under a `jax.profiler` trace and return
    per-kernel DEVICE times aggregated by XLA op/fusion name.

    The analog of the reference's per-pass GPU timestamp queries
    (`compute_query.rs:37-75`): where wgpu resolves two timestamps per
    compute pass, the trace's device plane carries one event per executed
    XLA kernel; this parses them programmatically (jax.profiler.ProfileData)
    instead of requiring TensorBoard.  Returns [(kernel, calls, total_ms)]
    sorted by total, and folds each into the process-wide timing log under
    ``device:<kernel>``.
    """
    import glob
    import os
    import tempfile

    from jax.profiler import ProfileData

    d = logdir or tempfile.mkdtemp(prefix="arrow_tpu_prof_")
    jax.profiler.start_trace(d)
    try:
        out = fn(*args)
        jax.block_until_ready(out)
    finally:
        jax.profiler.stop_trace()
    files = sorted(
        glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    agg: Dict[str, List[float]] = {}
    for f in files[-1:]:
        pd = ProfileData.from_file(f)
        for plane in pd.planes:
            is_dev = "GPU" in plane.name
            # CPU runs execute XLA thunks on tf_XLA* client threads
            is_cpu_xla = plane.name == "/host:CPU"
            if not (is_dev or is_cpu_xla):
                continue
            for line in plane.lines:
                if is_cpu_xla and not line.name.startswith("tf_XLA"):
                    continue
                for ev in line.events:
                    name = ev.name
                    if name.startswith(("$", "ThreadpoolListener", "Thunk")):
                        continue
                    a = agg.setdefault(name, [0.0, 0])
                    a[0] += float(ev.duration_ns)
                    a[1] += 1
    rows = sorted(
        ((n, int(c), ns / 1e6) for n, (ns, c) in agg.items()),
        key=lambda r: -r[2],
    )[:top]
    for n, _c, ms in rows:
        record(f"device:{n}", ms / 1e3)
    return rows


def device_summary(rows) -> str:
    lines = [f"{'kernel':48s} {'calls':>6s} {'total_ms':>10s}"]
    for n, c, ms in rows:
        lines.append(f"{n[:48]:48s} {c:6d} {ms:10.3f}")
    return "\n".join(lines)


# -- jax.profiler passthrough (device-level traces) --------------------------


def start_trace(logdir: str) -> None:
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()


@contextlib.contextmanager
def trace(logdir: str):
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
