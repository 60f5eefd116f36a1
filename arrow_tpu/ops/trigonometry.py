"""Trigonometry kernels: sin, cos, acos, sinh.

Redesign of `crates/trigonometry/` (traits
`lib.rs:22-83`, entry-point templating `lib.rs:85-137`, u8 impl
`u8_kernel.rs:12-53`).  Integer inputs (u8/i8/u16/i16) return Float32 arrays —
the reference's shaders unpack the lanes and convert to f32 in-kernel
(`trigonometry/compute_shaders/u8/trigonometry.wgsl`); here the conversion is a
fused astype.  Validity is cloned.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import dtypes as dt
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, register

_FNS = {
    "sin": jnp.sin,
    "cos": jnp.cos,
    "acos": jnp.arccos,
    "sinh": jnp.sinh,
}

#: input dtypes; integers produce FLOAT32 outputs (BUFFER_SIZE_MULTIPLIER
#: `lib.rs:85-137`)
_DTYPES = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
}


def _out_dtype(src: dt.ArrowType) -> dt.ArrowType:
    return src if dt.is_float(src) else dt.ArrowType.FLOAT32


def _trig_meta(avs, params):
    return [(_out_dtype(avs[0].dtype), avs[0].length)]


def _make_kernels():
    for name, fn in _FNS.items():

        def _impl(a: AV, _fn=fn) -> AV:
            odt = _out_dtype(a.dtype)
            x = a.data if dt.is_float(a.dtype) else a.data.astype(jnp.float32)
            return AV(_fn(x), a.validity, a.length, odt)

        register(f"trig_{name}", out_meta=_trig_meta)(_impl)


_make_kernels()


def _make_api(name):
    def fn(a, pipeline=None):
        if a.dtype not in _DTYPES:
            raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")
        return dispatch(f"trig_{name}", [a], pipeline=pipeline)

    return fn


for _name in _FNS:
    _fn = _make_api(_name)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)
