"""Distributed operators over ShardedBatches: filter, aggregate, join, sort, sum.

Net-new tier (BASELINE.md: distributed variants of the four north-star
operators, ">=75% rows/s scaling efficiency at N>=2 hosts").  Each operator is
one shard_map program; per-shard row counts stay device-resident so chained
operators never host-sync, and cross-shard redistribution reuses
`shuffle.hash_partition` (ONE all-to-all per shuffle).

Unlike the single-chip tier (arrow_tpu.compute), local lengths here are traced
values, so every kernel masks with `iota < count` instead of static slicing.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.lax as lax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import dtypes as dt
from ..errors import ArrowTpuError, OperationNotSupported
from ..utils import bits as B
from .mesh import MeshRuntime, smap
from .sharding import ShardedBatch, ShardedColumn
from .shuffle import _MESHES, hash_key, hash_partition


def _valid_local(data_len: int, count, validity_words=None):
    idx = lax.broadcasted_iota(jnp.int32, (data_len,), 0)
    m = idx < count
    if validity_words is not None:
        m = m & B.unpack_bits(validity_words)
    return m


def _mesh_for(rt: MeshRuntime):
    _MESHES[id(rt.mesh)] = rt.mesh
    return id(rt.mesh)


def _smap(rt: MeshRuntime, fn, in_specs, out_specs):
    return jax.jit(smap(fn, rt.mesh, in_specs, out_specs))


# ---------------------------------------------------------------------------
# distributed filter
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dist_filter_program(mesh_key, axis, cap, col_spec: tuple):
    mesh = _MESHES[mesh_key]

    from ..utils.scans import stable_partition

    def per_shard(counts, mask_words, mask_validity, *bufs):
        c = counts[0]
        mw = mask_words.reshape(-1)
        sel = B.unpack_bits(mw if mask_validity is None else (mw & mask_validity.reshape(-1)))
        sel = sel & (lax.broadcasted_iota(jnp.int32, (cap,), 0) < c)
        k = jnp.sum(sel, dtype=jnp.int32)
        live = lax.broadcasted_iota(jnp.int32, (cap,), 0) < k
        # one multi-operand stable-partition sort compacts every column at once
        operands = []
        layout = []  # (is_bool, has_validity) per column, operand slots in order
        bi = 0
        for name, dt_str, is_bool, has_validity in col_spec:
            data = bufs[bi].reshape(bufs[bi].shape[-1])
            bi += 1
            operands.append(B.unpack_bits(data) if is_bool else data)
            if has_validity:
                vw = bufs[bi].reshape(bufs[bi].shape[-1])
                bi += 1
                operands.append(B.unpack_bits(vw))
            layout.append((is_bool, has_validity))
        parts = stable_partition(sel, operands)
        outs = []
        pi = 0
        for is_bool, has_validity in layout:
            comp = parts[pi]
            pi += 1
            outs.append(B.pack_bits(comp & live) if is_bool else jnp.where(live, comp, jnp.zeros_like(comp)))
            if has_validity:
                outs.append(B.pack_bits(parts[pi] & live))
                pi += 1
        return (k[None], *[o[None] for o in outs])

    n_bufs = sum(1 + s[3] for s in col_spec)
    in_specs = (P(axis), P(axis, None), P(axis, None), *[P(axis, None)] * n_bufs)
    out_specs = (P(axis), *[P(axis, None)] * n_bufs)
    fn = smap(per_shard, mesh, in_specs, out_specs)
    return jax.jit(fn)


def distributed_filter(sb: ShardedBatch, mask: str) -> ShardedBatch:
    """Compact every shard by a BOOL mask column (no collectives needed)."""
    mcol = sb.columns[mask]
    if mcol.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("filter mask column must be BOOL")
    rt = sb.runtime
    names = [n for n in sb.columns if n != mask]
    col_spec = []
    bufs: List = []
    for n in names:
        col = sb.columns[n]
        col_spec.append(
            (n, str(col.data.dtype), col.dtype is dt.ArrowType.BOOL, col.validity is not None)
        )
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)
    mv = mcol.validity
    if mv is None:
        # uniform all-valid words so the program signature stays fixed
        mv = jnp.ones_like(mcol.data) * jnp.uint32(0xFFFFFFFF)
        mv = jax.device_put(mv, rt.sharding(rt.axis, None))
    prog = _dist_filter_program(_mesh_for(rt), rt.axis, sb.capacity, tuple(col_spec))
    outs = prog(sb.counts, mcol.data, mv, *bufs)
    new_counts = outs[0]
    out_cols: Dict[str, ShardedColumn] = {}
    oi = 1
    for n, dt_str, is_bool, has_validity in col_spec:
        data = outs[oi]
        oi += 1
        v = None
        if has_validity:
            v = outs[oi]
            oi += 1
        out_cols[n] = ShardedColumn(data, v, sb.columns[n].dtype)
    return ShardedBatch(out_cols, new_counts, rt)


# ---------------------------------------------------------------------------
# distributed sum / aggregate
# ---------------------------------------------------------------------------


def distributed_sum(sb: ShardedBatch, column: str):
    """Global sum of a column (local masked sum + psum over the mesh)."""
    col = sb.columns[column]
    if col.dtype is dt.ArrowType.BOOL:
        raise OperationNotSupported("sum over BOOL unsupported")
    rt = sb.runtime
    cap = sb.capacity
    axis = rt.axis

    def per_shard(counts, data, validity):
        c = counts[0]
        d = data.reshape(-1)
        m = _valid_local(cap, c, None if validity is None else validity.reshape(-1))
        local = jnp.sum(jnp.where(m, d, jnp.zeros_like(d)))
        return lax.psum(local, axis)[None]

    if col.validity is None:
        fn = _smap(
            rt,
            lambda c, d: per_shard(c, d, None),
            (P(axis), P(axis, None)),
            P(axis),
        )
        out = fn(sb.counts, col.data)
    else:
        fn = _smap(
            rt,
            per_shard,
            (P(axis), P(axis, None), P(axis, None)),
            P(axis),
        )
        out = fn(sb.counts, col.data, col.validity)
    return out[0]


@functools.lru_cache(maxsize=None)
def _dist_groupby_program(mesh_key, axis, cap, key_dt: str, key_has_v: bool, agg_spec: tuple):
    mesh = _MESHES[mesh_key]

    from ..compute.hash_aggregate import groupby_core

    def per_shard(counts, key_data, *bufs):
        c = counts[0]
        kd = key_data.reshape(-1)
        bi = 0
        kv = None
        if key_has_v:
            kv = bufs[0].reshape(-1)
            bi = 1
        kvalid = _valid_local(cap, c, kv)
        val_entries = []
        for agg, vdt_str, has_v in agg_spec:
            if agg == "count_all":
                continue
            vd = bufs[bi].reshape(-1)
            bi += 1
            vv = None
            if has_v:
                vv = bufs[bi].reshape(-1)
                bi += 1
            val_entries.append((vd, _valid_local(cap, c, vv)))
        g, out_keys, out_aggs = groupby_core(kd, kvalid, val_entries, agg_spec)
        return (g.astype(jnp.int32)[None], out_keys[None], *[a[None] for a in out_aggs])

    n_bufs = int(key_has_v) + sum(
        (0 if s[0] == "count_all" else (1 + s[2])) for s in agg_spec
    )
    in_specs = (P(axis), P(axis, None), *[P(axis, None)] * n_bufs)
    n_outs = 1 + len(agg_spec)
    out_specs = (P(axis), *[P(axis, None)] * n_outs)
    return jax.jit(
        smap(per_shard, mesh, in_specs, out_specs)
    )


def _local_aggregate(sb, key, aggregations):
    """Shard-local group-by (no collectives): the skew-aware pre-aggregation
    stage — heavy-hitter keys collapse to ONE row per shard before the
    shuffle, so the exchange volume is bounded by shards x distinct keys."""
    rt = sb.runtime
    kcol = sb.columns[key]
    agg_spec = []
    bufs: List = []
    if kcol.validity is not None:
        bufs.append(kcol.validity)
    for name, vc, kind in aggregations:
        if vc is None:
            agg_spec.append(("count_all", "", False))
            continue
        col = sb.columns[vc]
        agg_spec.append((kind, str(col.data.dtype), col.validity is not None))
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)
    prog = _dist_groupby_program(
        _mesh_for(rt), rt.axis, sb.capacity, str(kcol.data.dtype),
        kcol.validity is not None, tuple(agg_spec),
    )
    outs = prog(sb.counts, kcol.data, *bufs)
    return outs, kcol


def distributed_aggregate(
    sb: ShardedBatch,
    key: str,
    aggregations: Sequence[Tuple[str, Optional[str], str]],
    pre_partitioned: bool = False,
    pre_aggregate: bool = True,
    bucket_rows: Optional[int] = None,
) -> ShardedBatch:
    """GROUP BY across the mesh: (optionally) pre-aggregate each shard
    locally, hash-partition the partials by key (one all-to-all), then combine
    per shard — groups never span shards afterwards.

    Pre-aggregation is the skew-aware path (BASELINE "heavy-hitter skew"
    config): a key held by every row still ships at most P partial rows.  It
    applies when every aggregation decomposes (sum/count/min/max/mean);
    otherwise the raw rows are shuffled.

    aggregations: (out_name, value_column_name | None, kind).
    Returns a ShardedBatch of group rows {key, *outputs}.
    """
    decomposable = all(k in ("sum", "count", "min", "max") for _, _, k in aggregations)
    if pre_aggregate and decomposable and not pre_partitioned:
        outs, kcol = _local_aggregate(sb, key, aggregations)
        # build a partial-rows batch: key + one partial column per aggregation
        pcols = {"key": ShardedColumn(outs[1], None, kcol.dtype)}
        combine_aggs = []
        for (name, vc, kind), buf in zip(aggregations, outs[2:]):
            if kind == "count":
                pdt = dt.ArrowType.INT64
            else:
                pdt = sb.columns[vc].dtype
            pcols[name] = ShardedColumn(buf, None, pdt)
            # counts combine by summation in the second phase
            combine_aggs.append((name, name, "sum" if kind == "count" else kind))
        partial = ShardedBatch(pcols, outs[0], sb.runtime)
        shuffled = hash_partition(partial, "key", bucket_rows=bucket_rows)
        return distributed_aggregate(
            shuffled, "key", combine_aggs, pre_partitioned=True, pre_aggregate=False
        )

    if not pre_partitioned:
        sb = hash_partition(sb, key, bucket_rows=bucket_rows)
    rt = sb.runtime
    kcol = sb.columns[key]
    agg_spec = []
    bufs: List = []
    if kcol.validity is not None:
        bufs.append(kcol.validity)
    for name, vc, kind in aggregations:
        if vc is None:
            if kind != "count":
                raise OperationNotSupported("only count may omit the value column")
            agg_spec.append(("count_all", "", False))
            continue
        col = sb.columns[vc]
        agg_spec.append((kind, str(col.data.dtype), col.validity is not None))
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)
    prog = _dist_groupby_program(
        _mesh_for(rt), rt.axis, sb.capacity, str(kcol.data.dtype),
        kcol.validity is not None, tuple(agg_spec),
    )
    outs = prog(sb.counts, kcol.data, *bufs)
    new_counts = outs[0]
    cols = {"key": ShardedColumn(outs[1], None, kcol.dtype)}
    for (name, vc, kind), buf in zip(aggregations, outs[2:]):
        if kind == "count":
            cols[name] = ShardedColumn(buf, None, dt.ArrowType.INT64)
        elif kind == "mean":
            cols[name] = ShardedColumn(buf, None, dt.ArrowType.FLOAT64)
        else:
            cols[name] = ShardedColumn(buf, None, sb.columns[vc].dtype)
    return ShardedBatch(cols, new_counts, rt)


# ---------------------------------------------------------------------------
# distributed join
# ---------------------------------------------------------------------------


def join_shard_local(bcap, pcap, out_cap, bc, bk, bvalid, pc, pk, pvalid):
    """Traced per-shard sort-probe inner join (reused by the fused program).

    Returns (k, overflow, probe_idx, build_idx, live) where indices are local
    row ids and `live` masks the first k output slots.
    """
    from ..compute.join import build_order, probe_bounds

    sorder = build_order(bk, bvalid)
    lo, hi = probe_bounds(bk, bvalid, pk, pvalid)
    cnt = (hi - lo).astype(jnp.int64)
    offsets = jnp.cumsum(cnt) - cnt
    total = jnp.sum(cnt)
    j = lax.broadcasted_iota(jnp.int64, (out_cap,), 0)
    pi = jnp.minimum(
        jnp.searchsorted(offsets + cnt, j, side="right", method="sort"), pcap - 1
    )
    r = j - offsets[pi]
    bpos = jnp.clip(lo[pi].astype(jnp.int64) + r, 0, bcap - 1)
    bi_rows = sorder[bpos]
    live = j < jnp.minimum(total, out_cap)
    probe_idx = jnp.where(live, pi, 0).astype(jnp.uint32)
    build_idx = jnp.where(live, bi_rows, 0).astype(jnp.uint32)
    k = jnp.minimum(total, out_cap).astype(jnp.int32)
    return k, total > out_cap, probe_idx, build_idx, live


@functools.lru_cache(maxsize=None)
def _dist_join_program(mesh_key, axis, bcap, pcap, out_cap, key_dt, bv, pv):
    mesh = _MESHES[mesh_key]

    def per_shard(bcounts, bkeys, bvalidity, pcounts, pkeys, pvalidity):
        bc, pc = bcounts[0], pcounts[0]
        bk = bkeys.reshape(-1)
        pk = pkeys.reshape(-1)
        bvalid = _valid_local(bcap, bc, None if bvalidity is None else bvalidity.reshape(-1))
        pvalid = _valid_local(pcap, pc, None if pvalidity is None else pvalidity.reshape(-1))
        k, overflow, probe_idx, build_idx, _ = join_shard_local(
            bcap, pcap, out_cap, bc, bk, bvalid, pc, pk, pvalid
        )
        return k[None], overflow[None], probe_idx[None], build_idx[None]

    def mk(has_bv, has_pv):
        def f(bcounts, bkeys, pcounts, pkeys, *vs):
            vi = 0
            bval = None
            pval = None
            if has_bv:
                bval = vs[vi]; vi += 1
            if has_pv:
                pval = vs[vi]; vi += 1
            return per_shard(bcounts, bkeys, bval, pcounts, pkeys, pval)

        return f

    extra = int(bv) + int(pv)
    in_specs = (
        P(axis), P(axis, None), P(axis), P(axis, None), *[P(axis, None)] * extra
    )
    out_specs = (P(axis), P(axis), P(axis, None), P(axis, None))
    return jax.jit(
        smap(mk(bv, pv), mesh, in_specs, out_specs)
    )


def distributed_join_indices(
    build: ShardedBatch,
    probe: ShardedBatch,
    build_key: str,
    probe_key: str,
    out_capacity: Optional[int] = None,
    pre_partitioned: bool = False,
    bucket_rows: Optional[int] = None,
    check: bool = True,
):
    """Distributed inner equi-join: co-partition both sides by key hash (two
    all-to-alls), then per-shard sort-probe join.

    Returns (counts (P,), probe_row_idx ShardedColumn, build_row_idx
    ShardedColumn, partitioned_build, partitioned_probe): indices are local to
    the *partitioned* batches, which are returned so callers can gather payload
    columns.
    """
    if not pre_partitioned:
        build = hash_partition(build, build_key, bucket_rows=bucket_rows)
        probe = hash_partition(probe, probe_key, bucket_rows=bucket_rows)
    rt = build.runtime
    bcol, pcol = build.columns[build_key], probe.columns[probe_key]
    if bcol.dtype is not pcol.dtype:
        raise OperationNotSupported("join key dtypes must match")
    if not dt.is_integer(bcol.dtype):
        raise OperationNotSupported("join keys must be integer dtypes")
    out_cap = out_capacity or max(build.capacity, probe.capacity)
    prog = _dist_join_program(
        _mesh_for(rt), rt.axis, build.capacity, probe.capacity, out_cap,
        str(bcol.data.dtype), bcol.validity is not None, pcol.validity is not None,
    )
    vs = []
    if bcol.validity is not None:
        vs.append(bcol.validity)
    if pcol.validity is not None:
        vs.append(pcol.validity)
    k, overflow, probe_idx, build_idx = prog(
        build.counts, bcol.data, probe.counts, pcol.data, *vs
    )
    if check and bool(jnp.any(overflow)):
        raise ArrowTpuError(
            f"join output overflow: raise out_capacity (got {out_cap})"
        )
    return (
        k,
        ShardedColumn(probe_idx, None, dt.ArrowType.UINT32),
        ShardedColumn(build_idx, None, dt.ArrowType.UINT32),
        build,
        probe,
    )


@functools.lru_cache(maxsize=None)
def _dist_take_program(mesh_key, axis, src_cap, idx_cap, col_spec: tuple):
    """Per-shard gather: out[j] = col[idx[j]] for every column at once."""
    mesh = _MESHES[mesh_key]

    def per_shard(counts, idx, *bufs):
        k = counts[0]
        ix = idx.reshape(-1)
        live = lax.broadcasted_iota(jnp.int32, (idx_cap,), 0) < k
        outs = []
        bi = 0
        for name, dt_str, is_bool, has_validity in col_spec:
            data = bufs[bi].reshape(bufs[bi].shape[-1])
            bi += 1
            vals = B.unpack_bits(data) if is_bool else data
            taken = vals[ix]
            outs.append(
                B.pack_bits(taken & live)
                if is_bool
                else jnp.where(live, taken, jnp.zeros_like(taken))
            )
            if has_validity:
                vw = bufs[bi].reshape(bufs[bi].shape[-1])
                bi += 1
                outs.append(B.pack_bits(B.unpack_bits(vw)[ix] & live))
        return tuple(o[None] for o in outs)

    n_bufs = sum(1 + s[3] for s in col_spec)
    in_specs = (P(axis), P(axis, None), *[P(axis, None)] * n_bufs)
    out_specs = tuple([P(axis, None)] * n_bufs)
    return jax.jit(smap(per_shard, mesh, in_specs, out_specs))


def _sharded_take(sb: ShardedBatch, idx: ShardedColumn, counts) -> Dict[str, ShardedColumn]:
    rt = sb.runtime
    col_spec = []
    bufs: List = []
    for n, col in sb.columns.items():
        col_spec.append(
            (n, str(col.data.dtype), col.dtype is dt.ArrowType.BOOL, col.validity is not None)
        )
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)
    prog = _dist_take_program(
        _mesh_for(rt), rt.axis, sb.capacity, int(idx.data.shape[1]), tuple(col_spec)
    )
    outs = prog(counts, idx.data, *bufs)
    out_cols: Dict[str, ShardedColumn] = {}
    oi = 0
    for n, dt_str, is_bool, has_validity in col_spec:
        data = outs[oi]
        oi += 1
        v = None
        if has_validity:
            v = outs[oi]
            oi += 1
        out_cols[n] = ShardedColumn(data, v, sb.columns[n].dtype)
    return out_cols


def _batch_col_layout(sb: ShardedBatch, key: str):
    """(col_spec, bufs) with the key column first; spec rows are
    (name, dtype_str, is_bool, has_validity)."""
    names = [key] + [n for n in sb.columns if n != key]
    spec = []
    bufs: List = []
    for n in names:
        col = sb.columns[n]
        spec.append(
            (n, str(col.data.dtype), col.dtype is dt.ArrowType.BOOL, col.validity is not None)
        )
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)
    return tuple(spec), bufs


def _shard_payloads(spec, bufs):
    """Unpack shard-local buffers into (values, is_bool) payloads; the key's
    values come first, each column's validity rides as an extra bool payload."""
    payloads = []
    bi = 0
    for name, dt_str, is_bool, has_validity in spec:
        data = bufs[bi].reshape(bufs[bi].shape[-1])
        bi += 1
        payloads.append((B.unpack_bits(data) if is_bool else data, is_bool))
        if has_validity:
            vw = bufs[bi].reshape(bufs[bi].shape[-1])
            bi += 1
            payloads.append((B.unpack_bits(vw), True))
    return payloads


@functools.lru_cache(maxsize=None)
def _fused_join_program(
    mesh_key, axis, p, bcap, pcap, bbucket, pbucket, bout, pout, out_cap,
    bspec: tuple, pspec: tuple,
):
    """ONE program: build-side exchange + probe-side exchange + local join +
    payload gather, giving XLA's scheduler BOTH sides' all-to-alls and sorts
    to interleave — the XLA-native form of the BASELINE "double-buffered
    exchange overlapping probe compute".  `tools/overlap_ab.py` times it
    against the composed (partition, partition, join) sequence."""
    from ..parallel.shuffle import shuffle_shard_local

    mesh = _MESHES[mesh_key]

    def per_shard(bcounts, pcounts, *bufs):
        nb_bufs = sum(1 + s[3] for s in bspec)
        bbufs, pbufs = bufs[:nb_bufs], bufs[nb_bufs:]
        bpay = _shard_payloads(bspec, bbufs)
        ppay = _shard_payloads(pspec, pbufs)
        bc, b_over, b_outs = shuffle_shard_local(
            axis, p, bcap, bbucket, bout, bcounts[0], bpay[0][0], bpay
        )
        pc, p_over, p_outs = shuffle_shard_local(
            axis, p, pcap, pbucket, pout, pcounts[0], ppay[0][0], ppay
        )

        # validity bools of the key columns (exchanged alongside) if present
        def key_valid(spec, outs, cap_, c_):
            base = _valid_local(cap_, c_)
            if spec[0][3]:
                return outs[1] & base
            return base

        bvalid = key_valid(bspec, b_outs, bout, bc)
        pvalid = key_valid(pspec, p_outs, pout, pc)
        k, j_over, probe_idx, build_idx, live = join_shard_local(
            bout, pout, out_cap, bc, b_outs[0], bvalid, pc, p_outs[0], pvalid
        )

        # gather every column of both sides by its match indices
        def gather_side(spec, outs, idx):
            res = []
            oi = 0
            for name, dt_str, is_bool, has_validity in spec:
                vals = outs[oi][idx]
                oi += 1
                res.append(B.pack_bits(vals & live) if is_bool else jnp.where(live, vals, jnp.zeros_like(vals)))
                if has_validity:
                    res.append(B.pack_bits(outs[oi][idx] & live))
                    oi += 1
            return res

        out_cols = gather_side(pspec, p_outs, probe_idx) + gather_side(
            bspec, b_outs, build_idx
        )
        overflow = b_over | p_over | j_over
        return (k[None], overflow[None], *[o[None] for o in out_cols])

    nb_bufs = sum(1 + s[3] for s in bspec)
    np_bufs = sum(1 + s[3] for s in pspec)
    in_specs = (P(axis), P(axis), *[P(axis, None)] * (nb_bufs + np_bufs))
    out_specs = (P(axis), P(axis), *[P(axis, None)] * (nb_bufs + np_bufs))
    return jax.jit(smap(per_shard, mesh, in_specs, out_specs))


def distributed_join(
    left: ShardedBatch,
    right: ShardedBatch,
    left_on: str,
    right_on: str,
    out_capacity: Optional[int] = None,
    bucket_rows: Optional[int] = None,
    suffixes: Tuple[str, str] = ("_l", "_r"),
    check: bool = True,
    fused: bool = True,
) -> ShardedBatch:
    """Distributed inner equi-join returning the joined ShardedBatch; `right`
    is the build side.

    fused=True runs partition(build) + partition(probe) + local join + payload
    gather as ONE XLA program (overlapped collectives); fused=False composes
    the standalone shuffle and join programs.
    """
    if fused:
        rt = left.runtime
        p = rt.num_shards
        bcol, pcol = right.columns[right_on], left.columns[left_on]
        if bcol.dtype is not pcol.dtype or not dt.is_integer(bcol.dtype):
            raise OperationNotSupported("join keys must be matching integer dtypes")
        from ..array.array import pad_len

        bcap, pcap = right.capacity, left.capacity
        bbucket = min(bucket_rows or max(1024, -(-bcap // p) * 4), bcap)
        pbucket = min(bucket_rows or max(1024, -(-pcap // p) * 4), pcap)
        bout, pout = pad_len(2 * bcap), pad_len(2 * pcap)
        out_cap = out_capacity or max(bout, pout)
        bspec, bbufs = _batch_col_layout(right, right_on)
        pspec, pbufs = _batch_col_layout(left, left_on)
        prog = _fused_join_program(
            _mesh_for(rt), rt.axis, p, bcap, pcap, bbucket, pbucket, bout, pout,
            out_cap, bspec, pspec,
        )
        outs = prog(right.counts, left.counts, *bbufs, *pbufs)
        counts, overflow = outs[0], outs[1]
        if check and bool(jnp.any(overflow)):
            raise ArrowTpuError(
                "fused join overflow — raise bucket_rows/out_capacity"
            )
        cols: Dict[str, ShardedColumn] = {}
        oi = 2

        def unpack_side(spec, src_batch, is_probe):
            nonlocal oi
            for name, dt_str, is_bool, has_validity in spec:
                data = outs[oi]
                oi += 1
                v = None
                if has_validity:
                    v = outs[oi]
                    oi += 1
                if not is_probe and name == right_on and left_on == right_on:
                    continue  # key already present from the probe side
                if is_probe:
                    clash = name in right.column_names and not (
                        name == left_on and name == right_on
                    )
                    out_name = name + suffixes[0] if clash else name
                else:
                    out_name = (
                        name + suffixes[1] if name in left.column_names else name
                    )
                cols[out_name] = ShardedColumn(data, v, src_batch.columns[name].dtype)

        unpack_side(pspec, left, True)
        unpack_side(bspec, right, False)
        return ShardedBatch(cols, counts, rt)

    counts, pidx, bidx, pb, pp_ = distributed_join_indices(
        right, left, right_on, left_on,
        out_capacity=out_capacity, bucket_rows=bucket_rows, check=check,
    )
    lcols = _sharded_take(pp_, pidx, counts)
    rcols = _sharded_take(pb, bidx, counts)
    cols: Dict[str, ShardedColumn] = {}
    for n, c in lcols.items():
        clash = n in right.column_names and not (n == left_on and n == right_on)
        cols[n + suffixes[0] if clash else n] = c
    for n, c in rcols.items():
        if n == right_on and left_on == right_on:
            continue
        cols[n + suffixes[1] if n in left.column_names else n] = c
    return ShardedBatch(cols, counts, left.runtime)


# ---------------------------------------------------------------------------
# distributed sort (sample-splitter range partition + local sort)
# ---------------------------------------------------------------------------


from .shuffle import u32_decode as _u32_decode, u32_planes as _u32_planes  # noqa: E402


@functools.lru_cache(maxsize=None)
def _dist_sort_program(mesh_key, axis, p, cap, out_cap, bucket, n_samples, key_dt,
                       payload_spec):
    mesh = _MESHES[mesh_key]

    def per_shard(counts, key_data, *payloads):
        c = counts[0]
        kd = key_data.reshape(-1)
        valid = _valid_local(cap, c, None)
        maxval = (
            jnp.asarray(jnp.iinfo(kd.dtype).max, kd.dtype)
            if jnp.issubdtype(kd.dtype, jnp.integer)
            else jnp.asarray(jnp.inf, kd.dtype)
        )
        nkeys = jnp.where(valid, kd, maxval)

        # -- splitters: strided local sample -> all_gather -> quantiles -----
        stride = max(cap // n_samples, 1)
        sample = nkeys[:: stride][:n_samples]
        allsamp = lax.all_gather(sample, axis).reshape(-1)
        ssorted = jnp.sort(allsamp)
        qs = (jnp.arange(1, p) * (ssorted.shape[0] // p)).astype(jnp.int32)
        splitters = ssorted[qs]  # (p-1,) ascending

        dest = jnp.searchsorted(splitters, nkeys, side="right", method="sort").astype(jnp.int32)
        dest = jnp.where(valid, dest, p)

        rows = lax.broadcasted_iota(jnp.uint32, (cap,), 0)
        t_s, order = lax.sort([dest, rows], num_keys=1, is_stable=True)
        cnt = jnp.zeros((p + 1,), jnp.int32).at[dest].add(1)[:p]
        starts = jnp.cumsum(cnt) - cnt
        # bucket is sized from the expected per-destination row count (cap/p
        # x a static skew factor), NOT out_cap: the send tensor is
        # (p, bucket, planes) = O(cap x skew), no longer O(p x out_cap).
        # Buckets the splitter histogram overflows raise at the wrapper.
        j_ids = lax.broadcasted_iota(jnp.int32, (p, bucket), 1)
        gidx = jnp.clip(starts[:, None] + j_ids, 0, cap - 1)
        src_rows = order[gidx]
        send_over = jnp.any(cnt > bucket)

        rcnt = lax.all_to_all(jnp.minimum(cnt, bucket)[:, None], axis, 0, 0).reshape(p)
        roff = jnp.cumsum(rcnt) - rcnt
        total = jnp.sum(rcnt)
        out_i = lax.broadcasted_iota(jnp.int64, (out_cap,), 0)
        s_of = jnp.minimum(jnp.searchsorted(jnp.cumsum(rcnt), out_i, side="right", method="sort"), p - 1)
        j_of = jnp.clip((out_i - roff[s_of]).astype(jnp.int32), 0, bucket - 1)
        live_out = out_i < jnp.minimum(total, out_cap)

        # ONE fused all_to_all: key + every payload column ride as u32 planes
        # of a single (p, bucket, nplanes) tensor (one collective per
        # exchange, not one per column)
        planes = _u32_planes(nkeys)
        slices = [(0, len(planes), nkeys.dtype)]
        for pb in payloads:
            pd = pb.reshape(-1)
            ps = _u32_planes(pd)
            slices.append((len(planes), len(planes) + len(ps), pd.dtype))
            planes.extend(ps)
        send = jnp.stack([pl[src_rows] for pl in planes], axis=-1)
        recv = lax.all_to_all(send, axis, 0, 0)  # (p, bucket, nplanes)

        def dec(sl):
            lo, hi, dtp = sl
            return _u32_decode([recv[s_of, j_of, i] for i in range(lo, hi)], dtp)

        local_k = jnp.where(live_out, dec(slices[0]), maxval)
        recv_payloads = [
            jnp.where(live_out, dec(sl), jnp.zeros((), sl[2]))
            for sl in slices[1:]
        ]
        sorted_all = lax.sort([local_k, *recv_payloads], num_keys=1, is_stable=True)
        new_count = jnp.minimum(total, out_cap).astype(jnp.int32)
        overflow = (total > out_cap) | send_over
        return (new_count[None], overflow[None], *[s[None] for s in sorted_all])

    n_payloads = len(payload_spec)
    in_specs = (P(axis), P(axis, None), *[P(axis, None)] * n_payloads)
    out_specs = (P(axis), P(axis), *[P(axis, None)] * (1 + n_payloads))
    return jax.jit(
        smap(per_shard, mesh, in_specs, out_specs)
    )


def distributed_sort(
    sb: ShardedBatch,
    key: str,
    out_capacity: Optional[int] = None,
    n_samples: int = 256,
    skew_factor: Optional[int] = None,
    check: bool = True,
) -> ShardedBatch:
    """Globally sort by `key`: sampled splitters -> range-partition all-to-all
    -> local sort.  Shard s holds globally-ordered range s.  Null keys are
    unsupported (sort semantics of the bench configs: dense key+payload).

    Send-bucket sizing: by default the per-destination send
    bucket is 4x the balanced share (cap / num_shards) — O(cap * skew) send
    tensors instead of O(P * cap) — and a key distribution the sampled
    splitters mis-balance past that bound triggers ONE automatic retry at
    bucket = cap, at which send overflow is impossible for any distribution
    (cnt <= cap).  A remaining overflow is receive-side (out_capacity too
    small) and raises.  Passing `skew_factor` explicitly pins the bucket at
    skew_factor x the balanced share with no retry: overflow raises (or,
    with check=False, truncates silently)."""
    rt = sb.runtime
    kcol = sb.columns[key]
    if kcol.validity is not None or kcol.dtype is dt.ArrowType.BOOL:
        raise OperationNotSupported("distributed_sort: non-null primitive keys only")
    payload_names = [n for n in sb.columns if n != key]
    for n in payload_names:
        col = sb.columns[n]
        if col.validity is not None or col.dtype is dt.ArrowType.BOOL:
            raise OperationNotSupported("distributed_sort payload must be non-null primitive")
    out_cap = out_capacity or 2 * sb.capacity
    auto_retry = skew_factor is None
    sf = 4 if skew_factor is None else skew_factor
    bucket = min(sb.capacity, sf * -(-sb.capacity // rt.num_shards))

    def run(bucket):
        prog = _dist_sort_program(
            _mesh_for(rt), rt.axis, rt.num_shards, sb.capacity, out_cap, bucket,
            n_samples,
            str(kcol.data.dtype),
            tuple((str(sb.columns[n].data.dtype),) for n in payload_names),
        )
        return prog(sb.counts, kcol.data, *[sb.columns[n].data for n in payload_names])

    outs = run(bucket)
    new_counts, overflow = outs[0], outs[1]
    if bool(jnp.any(overflow)) and auto_retry and bucket < sb.capacity:
        # skewed past the histogram bound: retry once at the always-safe
        # full-capacity bucket (send overflow impossible: cnt <= cap)
        outs = run(sb.capacity)
        new_counts, overflow = outs[0], outs[1]
    if check and bool(jnp.any(overflow)):
        raise ArrowTpuError(
            "distributed_sort receive overflow; raise out_capacity"
            if auto_retry
            else "distributed_sort capacity overflow; raise out_capacity/skew_factor"
        )
    cols = {key: ShardedColumn(outs[2], None, kcol.dtype)}
    for n, buf in zip(payload_names, outs[3:]):
        cols[n] = ShardedColumn(buf, None, sb.columns[n].dtype)
    return ShardedBatch(cols, new_counts, rt)
