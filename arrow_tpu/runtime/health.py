"""Device health checking and guarded execution.

The reference has no failure detection (SURVEY.md §5: errors surface as
panics).  A production deployment needs at least: a liveness probe (a call
to a device can hang), and a way to bound the blast radius of a hung call.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import Any, Callable, Optional

log = logging.getLogger("arrow_tpu")


class DeviceWedgedError(RuntimeError):
    """The device did not answer a trivial op within the deadline."""


def probe_device(timeout_s: float = 30.0, device=None) -> float:
    """Round-trip a trivial computation; returns latency seconds.

    Raises DeviceWedgedError on timeout.  NOTE: a wedged PJRT call cannot be
    cancelled — the worker thread leaks until the runtime recovers; callers
    should treat a failed probe as fatal for this process.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    def _ping() -> float:
        t0 = time.perf_counter()
        x = jnp.zeros((8,), jnp.float32)
        np.asarray(x + 1.0)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_ping)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise DeviceWedgedError(
                f"device did not answer within {timeout_s}s"
            ) from None


def with_deadline(fn: Callable[[], Any], timeout_s: float, default: Any = None):
    """Run fn in a worker thread with a deadline; returns (ok, result).

    On timeout the call keeps running detached (PJRT calls are not
    cancellable); the caller decides whether to continue or abort.
    """
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(fn)
    try:
        return True, fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        log.error("arrow_tpu: call exceeded %.0fs deadline", timeout_s)
        return False, default
    finally:
        pool.shutdown(wait=False)
