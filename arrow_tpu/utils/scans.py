"""Scan/partition primitives shared by the operator tier.

Every compaction here is a stable sort on a 0/1 partition key (selected rows
first, original order preserved), and every segment reduction a segmented
scan built from log2(n) fused shift+combine passes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.lax as lax
import jax.numpy as jnp


def stable_partition(flags: jnp.ndarray, operands: Sequence[jnp.ndarray]):
    """Move rows where flags=True to the front (stable), carrying operands.

    Returns the list of permuted operands: one fused multi-operand stable
    sort on a 1-bit key.  Unselected rows follow the selected ones in their
    original order; callers that need a zeroed tail mask it themselves.
    """
    rank = (~flags).astype(jnp.int32)
    out = lax.sort([rank, *operands], num_keys=1, is_stable=True)
    return out[1:]


def segmented_scan(
    vals: jnp.ndarray, starts: jnp.ndarray, combine: Callable
) -> jnp.ndarray:
    """Inclusive scan of `vals` with `combine`, restarting at rows where
    `starts` is True.

    Hillis-Steele segmented scan: log2(n) fused shift+combine passes.
    """
    n = vals.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    v, f = vals, starts
    d = 1
    while d < n:
        pv = jnp.roll(v, d)
        pf = jnp.roll(f, d)
        has_pred = idx >= d
        take = has_pred & (~f)
        v = jnp.where(take, combine(pv, v), v)
        f = f | (has_pred & pf)
        d <<= 1
    return v


def shift_cummax(v: jnp.ndarray, reverse: bool = False) -> jnp.ndarray:
    """Cumulative max as log2(n) fused shift+max passes."""
    n = v.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    d = 1
    while d < n:
        s = jnp.roll(v, -d if reverse else d)
        ok = (idx < n - d) if reverse else (idx >= d)
        v = jnp.where(ok, jnp.maximum(v, s), v)
        d <<= 1
    return v


def sort_limbs(keys: jnp.ndarray) -> list:
    """Decompose an integer key column into <=32-bit sort keys, high limb
    first, so multi-key `lax.sort` orders identically to the 64-bit compare.
    """
    if keys.dtype == jnp.uint64:
        w = lax.bitcast_convert_type(keys, jnp.uint32)  # (n, 2): lo, hi
        return [w[:, 1], w[:, 0]]
    if keys.dtype == jnp.int64:
        w = lax.bitcast_convert_type(keys, jnp.uint32)
        return [lax.bitcast_convert_type(w[:, 1], jnp.int32), w[:, 0]]
    return [keys]


def segment_ends(starts: jnp.ndarray, n_valid) -> jnp.ndarray:
    """End-of-segment flags given start flags over the valid prefix.

    Row i ends its segment iff row i+1 starts one (or i is the last valid row).
    """
    n = starts.shape[0]
    nxt = jnp.roll(starts, -1).at[n - 1].set(True)
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    in_range = idx < n_valid
    is_last = idx == (n_valid - 1)
    return in_range & (nxt | is_last)
