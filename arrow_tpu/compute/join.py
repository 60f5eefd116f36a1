"""Hash join: inner equi-join on integer keys, duplicates supported.

Net-new north-star operator (BASELINE.md: "distributed hash join: 1B x 1B
u64-key equi-join, hash-partitioned across N>=2 hosts, skewed keys").  This
module is the single-device operator; `arrow_tpu.parallel.distributed_ops`
hash-partitions both sides across the mesh and runs this per shard.

Design (sort-probe): instead of a pointer-chasing hash table, per-probe match
bounds come from ONE tag co-sort of build+probe keys (`probe_bounds`), then an
emit pass expands the ranges:

  sort concat(build, probe) by (key limbs..., is_build) — probe first on ties
  b4[c]       = #build rows before sorted position c (cumsum)
  lo (probe)  = b4[c]                     (ties place build rows after it)
  hi (probe)  = nb - (#build after own key segment)   (reverse propagation)
  match_count = hi - lo          (handles duplicate build keys)
  total       = sum(match_count)              -> host sync, output size
  out position  j emits probe row  i = searchsorted(offsets, j, 'right')-1
                 and build row  order[lo[i] + (j - offsets[i])]

64-bit keys are decomposed into 32-bit limb columns and sorted with
`num_keys=2` (`utils.scans.sort_limbs`).

Null semantics: NULL keys never match (dropped from both sides).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B


def _valid_mask(data, validity, length):
    n = data.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    in_range = idx < length
    if validity is None:
        return in_range
    return B.unpack_bits(validity) & in_range


def probe_bounds(bkeys, bvalid, pkeys, pvalid, ordered: bool = True):
    """Per-probe [lo, hi) match ranks among valid build rows.

    ONE multi-key sort of concat(build, probe) + one unsort replaces the two
    `searchsorted(..., method='sort')` co-sorts (4 internal sorts) of the
    naive formulation, and limb decomposition keeps 64-bit keys exact without
    emulated 64-bit comparators.

    ordered=False skips the unsort and returns bounds in co-sorted key order
    with probe rows marked by isb==0 — enough for count-only consumers.
    """
    from ..utils.scans import shift_cummax, sort_limbs

    n, m = bkeys.shape[0], pkeys.shape[0]
    keys = [
        jnp.concatenate([b, p])
        for b, p in zip(sort_limbs(bkeys), sort_limbs(pkeys))
    ]
    # invalid build rows tagged as non-build: they count toward no probe.
    # isb rides as payload, not key: lo/hi are derived from key-segment
    # boundaries, so tie order between build and probe rows is irrelevant.
    isb = jnp.concatenate(
        [bvalid.astype(jnp.int32), jnp.zeros((m,), jnp.int32)]
    )
    payload = [isb]
    if ordered:
        payload.append(lax.broadcasted_iota(jnp.uint32, (n + m,), 0))
    out = lax.sort([*keys, *payload], num_keys=len(keys))
    skeys, sb = out[: len(keys)], out[len(keys)]
    b4 = (jnp.cumsum(sb) - sb).astype(jnp.int32)
    idx = lax.broadcasted_iota(jnp.int32, (n + m,), 0)
    start = idx == 0
    for sk in skeys:
        start = start | (sk != jnp.roll(sk, 1))
    # lo = #build rows in strictly-earlier key segments = b4 at segment start;
    # b4 is non-decreasing, so masked cummax propagates it across the segment
    lo_s = shift_cummax(jnp.where(start, b4, -1))
    nbv = jnp.sum(sb, dtype=jnp.int32)
    after = nbv - b4 - sb  # build rows strictly after c
    end = jnp.roll(start, -1).at[n + m - 1].set(True)
    hi_s = nbv - shift_cummax(jnp.where(end, after, -1), reverse=True)
    if not ordered:
        return jnp.where(sb == 0, lo_s, 0), jnp.where(sb == 0, hi_s, 0)
    sorig = out[len(keys) + 1]
    # restore original order: one single-key sort carrying both bounds
    _, lo_o, hi_o = lax.sort([sorig, lo_s, hi_s], num_keys=1)
    lo_p, hi_p = lo_o[n:], hi_o[n:]
    lo_p = jnp.where(pvalid, lo_p, 0)
    hi_p = jnp.where(pvalid, hi_p, 0)
    return lo_p, jnp.maximum(hi_p, lo_p)


def build_order(bkeys, bvalid):
    """Valid build rows' ids in key order (rank -> row id), invalid last."""
    from ..utils.scans import sort_limbs

    rows = lax.broadcasted_iota(jnp.uint32, (bkeys.shape[0],), 0)
    limbs = sort_limbs(bkeys)
    rank = jnp.where(bvalid, 0, 1).astype(jnp.int32)
    out = lax.sort([rank, *limbs, rows], num_keys=1 + len(limbs), is_stable=True)
    return out[-1]


@functools.lru_cache(maxsize=None)
def _count_program(spec: tuple):
    (nb, lb, bv, np_, lp, pv) = spec

    def run(bkeys, bvalidity, pkeys, pvalidity):
        bvalid = _valid_mask(bkeys, bvalidity, lb)
        pvalid = _valid_mask(pkeys, pvalidity, lp)
        sorder = build_order(bkeys, bvalid)
        lo, hi = probe_bounds(bkeys, bvalid, pkeys, pvalid)
        cnt = (hi - lo).astype(jnp.int64)
        offsets = jnp.cumsum(cnt) - cnt
        total = jnp.sum(cnt)
        return total, cnt, offsets, lo, sorder

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _emit_program(out_cap: int):
    def run(cnt, offsets, lo, sorder, total):
        j = lax.broadcasted_iota(jnp.int64, (out_cap,), 0)
        # probe row for each output slot: last offset <= j
        pi = jnp.searchsorted(offsets + cnt, j, side="right", method="sort")
        pi = jnp.minimum(pi, offsets.shape[0] - 1)
        r = j - offsets[pi]
        bpos = lo[pi].astype(jnp.int64) + r
        bi = sorder[jnp.clip(bpos, 0, sorder.shape[0] - 1)]
        live = j < total
        probe_idx = jnp.where(live, pi, 0).astype(jnp.uint32)
        build_idx = jnp.where(live, bi, 0).astype(jnp.uint32)
        return probe_idx, build_idx

    return jax.jit(run)


def _bucket(n: int) -> int:
    """Round capacity up to limit emit-program recompiles."""
    n = max(n, 1)
    b = pad_len(n)
    p = 1024
    while p < b:
        p <<= 1
    return p


def join_indices(
    build_keys: ArrowArrayBase, probe_keys: ArrowArrayBase
) -> Tuple[ArrowArrayBase, ArrowArrayBase, int]:
    """Inner-join match pairs: (probe_indices, build_indices, count)."""
    for k in (build_keys, probe_keys):
        if not dt.is_integer(k.dtype):
            raise OperationNotSupported(f"join key dtype {k.dtype.value} unsupported")
    if build_keys.dtype is not probe_keys.dtype:
        raise OperationNotSupported("join key dtypes must match")
    if build_keys.length == 0 or probe_keys.length == 0:
        import jax.numpy as _jnp

        empty = _jnp.zeros((0,), _jnp.uint32)
        dev = probe_keys.device
        return (
            make_array(empty, None, 0, dt.ArrowType.UINT32, dev),
            make_array(empty, None, 0, dt.ArrowType.UINT32, dev),
            0,
        )
    spec = (
        int(build_keys.data.shape[0]), build_keys.length, build_keys.validity is not None,
        int(probe_keys.data.shape[0]), probe_keys.length, probe_keys.validity is not None,
    )
    dev = probe_keys.device
    cp = _count_program(spec)
    total, cnt, offsets, lo, sorder = cp(
        build_keys.data, build_keys.validity, probe_keys.data, probe_keys.validity
    )
    t = int(total)
    cap = _bucket(t)
    ep = _emit_program(cap)
    probe_idx, build_idx = ep(cnt, offsets, lo, sorder, total)
    return (
        make_array(probe_idx, None, t, dt.ArrowType.UINT32, dev),
        make_array(build_idx, None, t, dt.ArrowType.UINT32, dev),
        t,
    )


def hash_join(
    left: RecordBatch,
    right: RecordBatch,
    left_on: str,
    right_on: str,
    suffixes: Tuple[str, str] = ("_l", "_r"),
) -> RecordBatch:
    """Inner equi-join of two RecordBatches; `right` is the build side."""
    probe_idx, build_idx, t = join_indices(right[right_on], left[left_on])
    from ..kernels import take as _take

    cols = {}
    for name, col in left.columns().items():
        clash = name in right.column_names and not (
            name == left_on and name == right_on
        )
        cols[name + suffixes[0] if clash else name] = _take(col, probe_idx)
    for name, col in right.columns().items():
        if name == right_on and left_on == right_on:
            continue  # key column already present from the left side
        out_name = name + suffixes[1] if name in left.column_names else name
        cols[out_name] = _take(col, build_idx)
    return RecordBatch(cols)
