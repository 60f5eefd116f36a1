"""Device time per iteration of a shape-preserving op.

Wall-clock around a single dispatch includes dispatch and readback latency.
`device_seconds_per_iter` instead runs K dependent iterations of the op inside
ONE jitted `lax.fori_loop` program and reads one element back, for two values
of K; the slope (T_hi - T_lo) / (K_hi - K_lo) cancels dispatch, compile and
readback overhead and yields pure device time per iteration.

The op must be shape-preserving (out pytree same shapes as in) so iterations
chain data-dependently — this is what prevents XLA from hoisting or CSE-ing
identical iterations out of the loop.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np


def _chained_program(fn: Callable, k: int):
    @jax.jit
    def run(args):
        def body(i, a):
            out = fn(*a)
            out = out if isinstance(out, tuple) else (out,)
            # barrier: stop XLA fusing/unrolling consecutive iterations into a
            # single memory pass (which would under-report elementwise ops)
            return lax.optimization_barrier(out)

        return lax.fori_loop(0, k, body, args, unroll=False)

    return run


def _run_once(prog, args) -> float:
    t0 = time.perf_counter()
    out = prog(args)
    # force completion with tiny readbacks of EVERY leaf: reading only the
    # first leaf under-measures when that leaf is a pass-through of an input
    # (XLA aliases the buffer, so its data is available before the program
    # finishes).  The extra per-leaf roundtrips are a constant the two-K
    # slope cancels.
    for leaf in jax.tree_util.tree_leaves(out):
        np.asarray(leaf.ravel()[:1])
    return time.perf_counter() - t0


def device_seconds_per_iter(
    fn: Callable,
    args,
    k_lo: int = 3,
    k_hi: int = 13,
    repeats: int = 2,
) -> float:
    """Median device-seconds per application of `fn` (shape-preserving pytree->
    pytree).

    Robust to transient host stalls: samples slopes until at least max(repeats, 3) are POSITIVE and the best pair agrees
    within 30%, up to 6 samples, and returns the median of the positives.
    """
    args = args if isinstance(args, tuple) else (args,)
    k_lo, k_hi = int(k_lo), int(k_hi)
    lo = _chained_program(fn, k_lo)
    hi = _chained_program(fn, k_hi)
    for prog in (lo, hi):  # warm both compiles
        _run_once(prog, args)
    want = max(int(repeats), 3)
    slopes: list = []
    for _ in range(6):
        t_lo = _run_once(lo, args)
        t_hi = _run_once(hi, args)
        slopes.append((t_hi - t_lo) / (k_hi - k_lo))
        pos = sorted(s for s in slopes if s > 0)
        if len(pos) >= want:
            # accept once the two closest samples agree within 30%
            gaps = [b / a for a, b in zip(pos, pos[1:])]
            if gaps and min(gaps) < 1.3:
                break
    pos = [s for s in slopes if s > 0]
    return max(float(np.median(pos or slopes)), 1e-9)
