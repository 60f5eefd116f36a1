"""Hash-partition shuffle: the all-to-all exchange layer.

Net-new component (BASELINE.md north star: "build/probe shuffles run as ragged
all-to-all with skew-aware repartitioning").  The reference has no
distributed layer at all (SURVEY.md §2 absence statement).

Design: JAX collectives want static shapes, so the ragged exchange
is bucketed (SURVEY.md §7 hard parts: "padded bucketing"): inside one shard_map
program each shard

  1. hashes its keys (murmur3 finalizer) to a destination shard,
  2. stable-sorts rows by destination (grouping them),
  3. gathers each destination's rows into a (P, bucket) send tensor,
  4. exchanges send tensors + per-destination counts with ONE `lax.all_to_all`
     over the mesh axis (XLA hands it to the device collectives library),
  5. compacts the received buckets back into a dense local batch.

Everything fuses into a single XLA program — route + exchange + compaction; the
collective overlaps with the gather/compaction compute where XLA's scheduler
allows.  Rows whose bucket overflows are dropped and counted; callers pass a
larger ``bucket_rows`` (skew slack) or check ``overflow``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.lax as lax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import dtypes as dt
from ..errors import ArrowTpuError
from ..utils import bits as B
from .mesh import smap
from .sharding import ShardedBatch, ShardedColumn


def fmix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 32-bit finalizer — full-avalanche integer hash."""
    x = x.astype(jnp.uint32)
    x ^= x >> 16
    x *= jnp.uint32(0x85EBCA6B)
    x ^= x >> 13
    x *= jnp.uint32(0xC2B2AE35)
    x ^= x >> 16
    return x


def fmix64(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3/splitmix 64-bit finalizer."""
    x = x.astype(jnp.uint64)
    x ^= x >> 33
    x *= jnp.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> 33
    x *= jnp.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> 33
    return x


def hash_key(data: jnp.ndarray) -> jnp.ndarray:
    if data.dtype.itemsize == 8:
        return fmix64(data.astype(jnp.uint64)).astype(jnp.uint32)
    return fmix32(data.astype(jnp.uint32))


def u32_planes(arr):
    """Encode one column as u32 planes for a fused exchange tensor.

    64-bit dtypes split into lo/hi limbs; sub-32-bit dtypes widen via astype
    (mod-2^32 wrap, exactly inverted by the narrowing astype in
    `u32_decode` — bitcast requires matching widths and would raise); 32-bit
    dtypes bitcast.  Shared by the shuffle and dist-sort exchanges.
    """
    dt_ = jnp.dtype(arr.dtype)
    if dt_.itemsize == 8:
        w = lax.bitcast_convert_type(arr, jnp.uint32)
        return [w[..., 0], w[..., 1]]
    if dt_.itemsize < 4:
        return [arr.astype(jnp.uint32)]
    if dt_ == jnp.uint32:
        return [arr]
    return [lax.bitcast_convert_type(arr, jnp.uint32)]


def u32_decode(words, dtype):
    """Inverse of `u32_planes` given the gathered word planes."""
    dt_ = jnp.dtype(dtype)
    if dt_.itemsize == 8:
        return lax.bitcast_convert_type(jnp.stack(words, axis=-1), dt_)
    if dt_.itemsize < 4:
        return words[0].astype(dt_)
    if dt_ == jnp.uint32:
        return words[0]
    return lax.bitcast_convert_type(words[0], dt_)


def _col_to_bools(col_data, is_bool):
    return B.unpack_bits(col_data) if is_bool else col_data


def shuffle_shard_local(axis, p, cap, bucket, out_cap, c, key_data, payloads):
    """Traced per-shard hash-partition exchange, reusable inside any shard_map
    program (the fused distributed join composes two of these with the local
    probe so XLA overlaps both all-to-alls with the sort/probe compute).

    key_data: (cap,) routing keys; payloads: list of (values, is_bool) where
    values is a (cap,) value array (bools already unpacked).  Returns
    (new_count, overflow, out_values list aligned with payloads).
    """
    n_idx = lax.broadcasted_iota(jnp.int32, (cap,), 0)
    valid = n_idx < c

    # -- route -------------------------------------------------------------
    t = jnp.where(valid, (hash_key(key_data) % jnp.uint32(p)).astype(jnp.int32), p)
    rows = lax.broadcasted_iota(jnp.uint32, (cap,), 0)
    t_s, order = lax.sort([t, rows], num_keys=1, is_stable=True)

    cnt = jnp.zeros((p + 1,), jnp.int32).at[t].add(1)[:p]
    starts = jnp.cumsum(cnt) - cnt
    over_send = jnp.any(cnt > bucket)

    # (p, bucket) gather map into the dest-grouped ordering
    j_ids = lax.broadcasted_iota(jnp.int32, (p, bucket), 1)
    gidx = jnp.clip(starts[:, None] + j_ids, 0, cap - 1)
    src_rows = order[gidx]  # (p, bucket) local row ids to send

    # -- exchange ----------------------------------------------------------
    rcnt = lax.all_to_all(
        jnp.minimum(cnt, bucket)[:, None], axis, 0, 0, tiled=False
    ).reshape(p)
    roff = jnp.cumsum(rcnt) - rcnt
    total = jnp.sum(rcnt)
    over_recv = total > out_cap

    # output compaction map: slot i <- (source shard s, rank j)
    out_i = lax.broadcasted_iota(jnp.int64, (out_cap,), 0)
    s_of = jnp.searchsorted(jnp.cumsum(rcnt), out_i, side="right", method="sort")
    s_of = jnp.minimum(s_of, p - 1)
    j_of = (out_i - roff[s_of]).astype(jnp.int32)
    j_of = jnp.clip(j_of, 0, bucket - 1)
    live_out = out_i < jnp.minimum(total, out_cap)

    # ONE fused all_to_all: every payload column rides as u32 planes of a
    # single (p, bucket, nplanes) tensor (bools as 0/1 words, 64-bit columns
    # as lo/hi limb pairs) — one collective per exchange, not one per column
    planes, slices = [], []
    for vals, is_bool in payloads:
        # bools: receiver masks with live_out; slots past a bucket's count
        # are never read (j_of < rcnt), so no send-side slot_live mask needed
        ps = [vals.astype(jnp.uint32)] if is_bool else u32_planes(vals)
        slices.append((len(planes), len(planes) + len(ps)))
        planes.extend(ps)
    send = jnp.stack([pl[src_rows] for pl in planes], axis=-1)
    recv = lax.all_to_all(send, axis, 0, 0, tiled=False)  # (p, bucket, nplanes)

    outs = []
    for (vals, is_bool), (lo, hi) in zip(payloads, slices):
        words = [recv[s_of, j_of, i] for i in range(lo, hi)]
        if is_bool:
            outs.append((words[0] != 0) & live_out)
            continue
        out_vals = u32_decode(words, vals.dtype)
        outs.append(jnp.where(live_out, out_vals, jnp.zeros_like(out_vals)))

    new_count = jnp.minimum(total, out_cap).astype(jnp.int32)
    return new_count, over_send | over_recv, outs


@functools.lru_cache(maxsize=None)
def _shuffle_program(
    mesh_key, axis: str, p: int, cap: int, bucket: int, out_cap: int,
    col_spec: tuple
):
    """col_spec: ((name, dtype_str, is_bool, has_validity), ...); the first
    entry is the key column."""
    mesh = _MESHES[mesh_key]

    def per_shard(counts, *bufs):
        c = counts[0]
        key_data = bufs[0].reshape(-1)

        payloads = []
        bi = 0
        for name, dt_str, is_bool, has_validity in col_spec:
            data = bufs[bi].reshape(bufs[bi].shape[-1])
            bi += 1
            payloads.append((_col_to_bools(data, is_bool), is_bool))
            if has_validity:
                vwords = bufs[bi].reshape(bufs[bi].shape[-1])
                bi += 1
                payloads.append((B.unpack_bits(vwords), True))

        new_count, overflow, outs = shuffle_shard_local(
            axis, p, cap, bucket, out_cap, c, key_data, payloads
        )
        out_bufs = [B.pack_bits(o) if b else o for o, (_, b) in zip(outs, payloads)]
        return (new_count[None], overflow[None], *[o[None] for o in out_bufs])

    in_specs = [P(axis)]
    for name, dt_str, is_bool, has_validity in col_spec:
        in_specs.append(P(axis, None))
        if has_validity:
            in_specs.append(P(axis, None))
    n_out = sum(1 + s[3] for s in col_spec)
    out_specs = (P(axis), P(axis), *[P(axis, None)] * n_out)

    fn = smap(per_shard, mesh, tuple(in_specs), out_specs)
    return jax.jit(fn)


#: mesh registry so the lru cache key stays hashable
_MESHES: dict = {}


def hash_partition(
    sb: ShardedBatch,
    key: str,
    bucket_rows: Optional[int] = None,
    out_capacity: Optional[int] = None,
    check: bool = True,
) -> ShardedBatch:
    """Redistribute rows so equal keys land on the same shard.

    bucket_rows: per-(src,dst) exchange bucket (default cap/P * 4 skew slack,
    min 1 tile; a distribution skewed past that bound triggers ONE automatic
    retry at the always-safe bucket = cap, and a remaining overflow is
    receive-side — raise out_capacity).  out_capacity: post-shuffle per-shard
    capacity (default 2*cap).
    """
    rt = sb.runtime
    p = rt.num_shards
    cap = sb.capacity
    if key not in sb.columns:
        raise ArrowTpuError(f"unknown key column {key!r}")
    if sb.columns[key].dtype is dt.ArrowType.BOOL:
        raise ArrowTpuError("bool partition keys unsupported")
    from ..array.array import pad_len

    auto_retry = bucket_rows is None
    bucket = bucket_rows or max(1024, -(-cap // p) * 4)
    bucket = min(bucket, cap)
    # default output capacity carries 2x skew slack over balanced placement
    out_cap = out_capacity or pad_len(2 * cap)

    names = [key] + [n for n in sb.columns if n != key]
    col_spec = []
    bufs = [sb.counts]
    for n in names:
        col = sb.columns[n]
        col_spec.append(
            (n, str(col.data.dtype), col.dtype is dt.ArrowType.BOOL, col.validity is not None)
        )
        bufs.append(col.data)
        if col.validity is not None:
            bufs.append(col.validity)

    mesh_key = id(rt.mesh)
    _MESHES[mesh_key] = rt.mesh

    def run(bucket):
        prog = _shuffle_program(
            mesh_key, rt.axis, p, cap, bucket, out_cap, tuple(col_spec)
        )
        return prog(*bufs)

    outs = run(bucket)
    new_counts, overflow = outs[0], outs[1]
    if bool(jnp.any(overflow)) and auto_retry and bucket < cap:
        # skewed past the 4x-balanced bound: retry once at the always-safe
        # full-capacity bucket (send overflow impossible: cnt <= cap)
        outs = run(cap)
        new_counts, overflow = outs[0], outs[1]
    if check and bool(jnp.any(overflow)):
        raise ArrowTpuError(
            "shuffle receive overflow — raise out_capacity "
            f"(bucket={bucket}, out_cap={out_cap})"
            if auto_retry
            else "shuffle bucket/capacity overflow — raise bucket_rows/"
            f"out_capacity (bucket={bucket}, out_cap={out_cap})"
        )
    out_cols: Dict[str, ShardedColumn] = {}
    oi = 2
    for n, dt_str, is_bool, has_validity in col_spec:
        data = outs[oi]
        oi += 1
        v = None
        if has_validity:
            v = outs[oi]
            oi += 1
        out_cols[n] = ShardedColumn(data, v, sb.columns[n].dtype)
    return ShardedBatch(out_cols, new_counts, rt)
