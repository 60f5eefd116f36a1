"""Swizzle routines: merge (select-by-mask), take (gather), put (scatter).

Redesign of `crates/routines/` (``Swizzle`` trait
`lib.rs:28-79`, impl `lib.rs:81-171`, merge validity pipeline `merge.rs:17-86`,
take plumbing `take.rs:9-55`, put plumbing `put.rs:9-56`): WGSL gather/scatter
shaders become XLA gather/scatter ops; the boolean bit-gather shader
(`routines/compute_shaders/bool/take.wgsl`) becomes unpack-gather-pack fused by
XLA.

Semantics preserved:

- ``merge(a, b, mask)``: rows where the mask *value* bit is set come from `a`,
  else from `b` (mask rows that are null carry value bit 0 -> select `b`).
  Validity is the reference's exact 4-stage composition
  (`merge_null_buffers_op`, `merge.rs:17-86`, verified against
  `routines/src/bool.rs:136-187`):
  ``v = ((va & m) | (vb & ~m))`` — where a side with no validity buffer simply
  drops out (a quirk kept for row-for-row parity: if only one side tracks
  validity, rows selected from the *other* side are marked null) — then
  ``v &= mask_validity``.
- ``take(a, indexes)``: out[i] = a[indexes[i]]; gathers the validity bits too
  (`take.rs`, `bool.rs:33-46`).  Out-of-bounds indices clamp (wgpu robustness).
- ``put(src, src_indexes, dst, dst_indexes)``: dst[dst_idx[i]] = src[src_idx[i]];
  mutates `dst` in place (rebinds its device buffer — jax.Arrays are immutable).
  The reference leaves null handling ``todo!()`` (`lib.rs:164-169`); here nulls
  scatter with their values.

Reference dyn coverage: take {date32,u32,i32,f32,bool} (`take.rs:85-95`); put
{f32,i32,u32,date32,bool} (`put.rs:96-108`); merge all 8 dtypes + bool
(`merge.rs:122-143`).  Extended here to every dtype.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, register


def _merge_validity_4way(va, vb, mask_words, mask_validity):
    """The reference's merge_null_buffers_op, on packed words (traced)."""
    v1 = (va & mask_words) if va is not None else None
    v2 = (vb & ~mask_words) if vb is not None else None
    if v1 is not None and v2 is not None:
        merged = v1 | v2
    else:
        merged = v1 if v1 is not None else v2
    if merged is not None and mask_validity is not None:
        return merged & mask_validity
    if merged is None:
        return mask_validity  # clone (merge.rs:84)
    return merged


@register("merge")
def _merge_impl(a: AV, b: AV, mask: AV) -> AV:
    if a.dtype is dt.ArrowType.BOOL:
        out = (a.data & mask.data) | (b.data & ~mask.data)
    else:
        mbits = B.unpack_bits(mask.data)[: a.data.shape[0]]
        out = jnp.where(mbits, a.data, b.data)
    v = _merge_validity_4way(a.validity, b.validity, mask.data, mask.validity)
    return AV(out, v, a.length, a.dtype)


def _take_meta(avs, params):
    return [(avs[0].dtype, avs[1].length)]


@register("take", out_meta=_take_meta)
def _take_impl(a: AV, idx: AV) -> AV:
    indexes = idx.data  # padded; padding rows gather index 0, never read back
    if a.dtype is dt.ArrowType.BOOL:
        bits = B.unpack_bits(a.data)
        out = B.mask_tail(B.pack_bits(bits[indexes]), idx.length)
    else:
        out = a.data[indexes]
    v = None
    if a.validity is not None:
        vbits = B.unpack_bits(a.validity)
        v = B.mask_tail(B.pack_bits(vbits[indexes]), idx.length)
    return AV(out, v, idx.length, a.dtype)


def _put_meta(avs, params):
    return [(avs[2].dtype, avs[2].length)]


@register("put", out_meta=_put_meta)
def _put_impl(src: AV, src_idx: AV, dst: AV, dst_idx: AV) -> AV:
    n = min(src_idx.length, dst_idx.length)
    si = src_idx.data[:n]
    di = dst_idx.data[:n]
    if src.dtype is dt.ArrowType.BOOL:
        sbits = B.unpack_bits(src.data)
        dbits = B.unpack_bits(dst.data)
        out_bits = dbits.at[di].set(sbits[si])
        out = B.mask_tail(B.pack_bits(out_bits), dst.length)
    else:
        out = dst.data.at[di].set(src.data[si])
    v = dst.validity
    if src.validity is not None or dst.validity is not None:
        nw = dst.data.shape[0] if dst.dtype is dt.ArrowType.BOOL else None
        dv = dst.validity
        if dv is None:
            n_words = nw if nw is not None else (dst.data.shape[0] // 32 or 1)
            dv = B.tail_mask_words(n_words, dst.length)
        dvbits = B.unpack_bits(dv)
        if src.validity is not None:
            svbits = B.unpack_bits(src.validity)[si]
        else:
            svbits = jnp.ones((n,), dtype=jnp.bool_)
        v = B.mask_tail(B.pack_bits(dvbits.at[di].set(svbits)), dst.length)
    return AV(out, v, dst.length, dst.dtype)


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------


def merge(a, b, mask, pipeline=None):
    """Select a[i] where mask[i] else b[i] (≙ ``Swizzle::merge`` `lib.rs:28-45`)."""
    if a.dtype is not b.dtype:
        raise OperationNotSupported("merge requires matching dtypes")
    if mask.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("merge mask must be a BooleanArray")
    if len(a) != len(b) or len(a) != len(mask):
        raise OperationNotSupported("merge requires equal lengths")
    return dispatch("merge", [a, b, mask], pipeline=pipeline)


def merge_op(a, b, mask, pipeline):
    return merge(a, b, mask, pipeline)


merge_dyn = merge
merge_op_dyn = merge_op


def take(a, indexes, pipeline=None):
    """Gather: out[i] = a[indexes[i]] (≙ ``Swizzle::take`` `lib.rs:47-60`)."""
    if indexes.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("take indexes must be a UInt32Array")
    return dispatch("take", [a, indexes], pipeline=pipeline)


def take_op(a, indexes, pipeline):
    return take(a, indexes, pipeline)


take_dyn = take
take_op_dyn = take_op


def put(src, src_indexes, dst, dst_indexes, pipeline=None):
    """Scatter src[src_idx[i]] into dst[dst_idx[i]], mutating `dst` in place
    (≙ ``Swizzle::put`` `lib.rs:62-79`). In pipeline mode returns the new dst
    handle instead (bind-after-finish)."""
    if src.dtype is not dst.dtype:
        raise OperationNotSupported("put requires matching dtypes")
    for ix in (src_indexes, dst_indexes):
        if ix.dtype is not dt.ArrowType.UINT32:
            raise OperationNotSupported("put indexes must be UInt32Arrays")
    result = dispatch("put", [src, src_indexes, dst, dst_indexes], pipeline=pipeline)
    if pipeline is None and isinstance(dst, ArrowArrayBase):
        dst._data = result.data
        dst._validity = result.validity
        return None
    return result


def put_op(src, src_indexes, dst, dst_indexes, pipeline):
    return put(src, src_indexes, dst, dst_indexes, pipeline)


put_dyn = put
put_op_dyn = put_op
