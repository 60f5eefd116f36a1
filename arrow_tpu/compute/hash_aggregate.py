"""Hash aggregate: GROUP BY key with SUM / COUNT / MIN / MAX / MEAN.

Net-new north-star operator (BASELINE.md: "hash aggregate: GROUP BY u32,
SUM/COUNT/MIN/MAX, 1K-100M distinct keys incl. skew, >=80% HBM roofline").  The
reference's only reduction-class kernels — Sum and any/all (SURVEY.md §2 #13/#15)
— are the seeds of this tier.

Design: grouping is sort-based inside one fused XLA program, built from
sorts and scans (utils/scans.py):

  1. ONE stable key sort carrying every value column (and its validity flags)
     as extra sort operands — no post-sort gathers;
  2. group boundaries by neighbor comparison; per-group reductions as
     *segmented* associative scans (sum/count/min/max restart at group starts),
     so each group's result materializes at its END row;
  3. a stable-partition sort on the end-row flags compacts (key, results) rows
     to the front — groups come out in ascending key order.

This is robust to arbitrary key counts (1K..100M distinct) and heavy-hitter
skew: skew only changes segment lengths, not the program.  The result buffers
have input capacity; the host-synced group count is the logical length (one
executable across all key distributions, like the filter operator).

Null semantics (the reference defines none for aggregates): rows with a NULL
key are dropped; NULL values are skipped by sum/min/max and not counted by
count (standard SQL/Arrow semantics, documented extension).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B

AGG_KINDS = ("sum", "count", "min", "max", "mean")


def _valid_bools(data, validity, length):
    n = data.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    in_range = idx < length
    if validity is None:
        return in_range
    return B.unpack_bits(validity) & in_range


def groupby_core(key_data, kvalid, val_entries, agg_spec, length_hint=None,
                 dense=False):
    """Shared sort+segmented-scan group-by core (traceable).

    key_data: (n,) keys; kvalid: (n,) bool valid-key mask;
    val_entries: list of (vdata, vvalid_bools) aligned with non-count_all
    entries of agg_spec.  Returns (num_groups, out_keys, [out_agg...]) with
    group rows compacted to the front in ascending key order.

    dense (static bool): every row of every buffer is valid (no key/value
    nulls, no padding) — the sort drops the rank key and the per-value
    validity operands (both constant), cutting the dominant multi-operand
    sort cost by ~half for the common no-null full-buffer case.
    """
    from ..utils.scans import segment_ends, segmented_scan, stable_partition

    n = key_data.shape[0]
    if dense:
        operands = [key_data] + [vdata for vdata, _ in val_entries]
        raw = lax.sort(operands, num_keys=1, is_stable=True)
        skey = raw[0]
        true_plane = jnp.ones((n,), jnp.bool_)
        sorted_ = [None, skey]
        for sv in raw[1:]:
            sorted_.append(sv)
            sorted_.append(true_plane)
        in_group = true_plane
    else:
        rank = jnp.where(kvalid, 0, 1).astype(jnp.int32)
        operands = [rank, key_data]
        for vdata, vvalid in val_entries:
            operands.append(vdata)
            operands.append(vvalid)
        sorted_ = lax.sort(operands, num_keys=2, is_stable=True)
        srank, skey = sorted_[0], sorted_[1]
        in_group = srank == 0
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    starts = in_group & ((idx == 0) | (skey != jnp.roll(skey, 1)))
    num_groups = jnp.sum(starts, dtype=jnp.uint32)
    n_valid = jnp.sum(in_group, dtype=jnp.int32)
    ends = segment_ends(starts, n_valid)

    results = []
    post = []  # per-result dtype conversion applied AFTER compaction: count
    # scans run in int32 (counts <= n < 2^31), widening to the Arrow INT64
    # result at the end
    vi = 0
    for agg, val_dtype_str, _ in agg_spec:
        if agg == "count_all":
            seg_cnt = segmented_scan(
                in_group.astype(jnp.int32), starts, lambda a, b: a + b
            )
            results.append(seg_cnt)
            post.append(jnp.int64)
            continue
        vdt = jnp.dtype(val_dtype_str)
        svals = sorted_[2 + 2 * vi]
        svalid = sorted_[3 + 2 * vi] & in_group
        vi += 1
        if agg in ("sum", "mean"):
            acc_dt = jnp.float64 if jnp.issubdtype(vdt, jnp.floating) else jnp.int64
            if vdt == jnp.uint64:
                acc_dt = jnp.uint64
            contrib = jnp.where(svalid, svals.astype(acc_dt), jnp.asarray(0, acc_dt))
            ssum = segmented_scan(contrib, starts, lambda a, b: a + b)
            if agg == "sum":
                results.append(ssum.astype(vdt))
                post.append(None)
            else:
                cnt = segmented_scan(
                    svalid.astype(jnp.int32), starts, lambda a, b: a + b
                )
                results.append(
                    ssum.astype(jnp.float64)
                    / jnp.maximum(cnt, 1).astype(jnp.float64)
                )
                post.append(None)
        elif agg == "count":
            results.append(
                segmented_scan(
                    svalid.astype(jnp.int32), starts, lambda a, b: a + b
                )
            )
            post.append(jnp.int64)
        elif agg == "min":
            init = jnp.inf if jnp.issubdtype(vdt, jnp.floating) else jnp.iinfo(vdt).max
            contrib = jnp.where(svalid, svals, jnp.asarray(init, vdt))
            results.append(segmented_scan(contrib, starts, jnp.minimum))
            post.append(None)
        elif agg == "max":
            init = -jnp.inf if jnp.issubdtype(vdt, jnp.floating) else jnp.iinfo(vdt).min
            contrib = jnp.where(svalid, svals, jnp.asarray(init, vdt))
            results.append(segmented_scan(contrib, starts, jnp.maximum))
            post.append(None)
        else:
            raise OperationNotSupported(f"unknown aggregation {agg!r}")

    # compact (key, results) at group-end rows to the front, in key order
    parts = stable_partition(ends, [skey, *results])
    live = lax.broadcasted_iota(jnp.uint32, (n,), 0) < num_groups
    out_keys = jnp.where(live, parts[0], jnp.zeros_like(parts[0]))
    out_aggs = [
        jnp.where(live, p, jnp.zeros_like(p)).astype(t) if t is not None
        else jnp.where(live, p, jnp.zeros_like(p))
        for p, t in zip(parts[1:], post)
    ]
    return num_groups, out_keys, out_aggs


@functools.lru_cache(maxsize=None)
def _groupby_program(spec: tuple):
    """spec: (n_padded, length, key_has_validity,
    ((agg, val_dtype, val_has_validity), ...))"""
    n_padded, length, key_has_validity, agg_spec = spec

    def run(key_data, key_validity, *val_bufs):
        kvalid = _valid_bools(key_data, key_validity, length)
        val_entries = []
        vi = 0
        for agg, val_dtype_str, val_has_validity in agg_spec:
            if agg == "count_all":
                continue
            vdata = val_bufs[vi]
            vvalidity = val_bufs[vi + 1] if val_has_validity else None
            vi += 2 if val_has_validity else 1
            val_entries.append((vdata, _valid_bools(vdata, vvalidity, length)))
        dense = (
            not key_has_validity
            and length == n_padded
            and all(not hv for _a, _d, hv in agg_spec)
        )
        num_groups, out_keys, out_aggs = groupby_core(
            key_data, kvalid, val_entries, agg_spec, dense=dense,
        )
        return (num_groups, out_keys, *out_aggs)

    return jax.jit(run)


def hash_aggregate(
    keys: ArrowArrayBase,
    aggregations: Sequence[Tuple[str, Optional[ArrowArrayBase], str]],
    method: str = "auto",
) -> RecordBatch:
    """GROUP BY `keys` computing `aggregations`: (out_name, value_column, kind).

    kind in {sum, count, min, max, mean}; value_column None + kind "count"
    counts rows per group.  Returns a RecordBatch with column "key" + one column
    per aggregation; group order = ascending key order.

    method: "auto" or "sort" — both run the sort+segmented-scan program
    (any keys, values and nulls).
    """
    if method not in ("auto", "sort"):
        raise OperationNotSupported(f"unknown group-by method {method!r}")
    if not dt.is_integer(keys.dtype) and keys.dtype is not dt.ArrowType.DATE32:
        raise OperationNotSupported(f"group-by key dtype {keys.dtype.value} unsupported")
    agg_spec = []
    val_bufs: List = []
    for name, col, kind in aggregations:
        if kind not in AGG_KINDS:
            raise OperationNotSupported(f"unknown aggregation {kind!r}")
        if col is None:
            if kind != "count":
                raise OperationNotSupported("only count may omit the value column")
            agg_spec.append(("count_all", "", False))
            continue
        if len(col) != len(keys):
            raise OperationNotSupported("value column length mismatch")
        if col.dtype is dt.ArrowType.BOOL:
            raise OperationNotSupported("bool value columns unsupported")
        agg_spec.append((kind, str(jnp.dtype(col.data.dtype)), col.validity is not None))
        val_bufs.append(col.data)
        if col.validity is not None:
            val_bufs.append(col.validity)

    spec = (
        int(keys.data.shape[0]),
        keys.length,
        keys.validity is not None,
        tuple(agg_spec),
    )
    prog = _groupby_program(spec)
    outs = prog(keys.data, keys.validity, *val_bufs)
    num_groups = int(outs[0])
    device = keys.device

    def _wrap(buf, dtype):
        return make_array(buf, None, num_groups, dtype, device)

    cols: Dict[str, ArrowArrayBase] = {"key": _wrap(outs[1], keys.dtype)}
    for (name, col, kind), buf in zip(aggregations, outs[2:]):
        if kind == "count":
            cols[name] = _wrap(buf, dt.ArrowType.INT64)
        elif kind == "mean":
            cols[name] = _wrap(buf, dt.ArrowType.FLOAT64)
        else:
            cols[name] = _wrap(buf, col.dtype)
    return RecordBatch(cols)
