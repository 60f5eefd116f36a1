"""Broadcast: scalar -> constant array of a given length.

Redesign of the reference's ``Broadcast`` trait
(`crates/array/src/kernels/broadcast.rs:6-17`; f32 impl
`f32_gpu.rs:13-37`, packed u8 `u8_gpu.rs:9-29`, boolean CPU-side fill
`boolean_gpu.rs` broadcast): one fused ``jnp.full`` covers every dtype — the
reference's 8/16-bit lane-packing trick is unnecessary here.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import pad_len, pad_words
from ..array.scalar import Scalar
from ..utils import bits as B
from .kernel import AV, dispatch, register, scalar_av


def _bcast_meta(avs, params):
    return [(avs[0].dtype, params["length"])]


@register("broadcast", out_meta=_bcast_meta)
def _broadcast_impl(s: AV, length: int) -> AV:
    if s.dtype is dt.ArrowType.BOOL:
        nw = pad_words(length)
        val = s.data.astype(jnp.uint32) * jnp.uint32(0xFFFFFFFF)
        words = B.mask_tail(jnp.broadcast_to(val, (nw,)), length)
        return AV(words, None, length, s.dtype)
    data = jnp.broadcast_to(s.data, (pad_len(length),))
    return AV(data, None, length, s.dtype)


def broadcast(value, length: int, dtype: Optional[dt.ArrowType] = None, pipeline=None):
    """Create a constant array (≙ ``Float32ArrayGPU::broadcast(value, len, device)``)."""
    if isinstance(value, Scalar):
        sav = scalar_av(value, value.dtype)
    else:
        if dtype is None:
            if isinstance(value, bool):
                dtype = dt.ArrowType.BOOL
            elif isinstance(value, int):
                dtype = dt.ArrowType.INT32
            else:
                dtype = dt.ArrowType.FLOAT32
        sav = scalar_av(value, dtype)
    return dispatch("broadcast", [sav], params={"length": length}, pipeline=pipeline)


def broadcast_op(value, length, pipeline, dtype=None):
    return broadcast(value, length, dtype, pipeline)


broadcast_dyn = broadcast
broadcast_op_dyn = broadcast_op
