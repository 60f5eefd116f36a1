"""Cast kernels: dtype conversions and bit reinterpretation.

Redesign of `crates/cast/` (``Cast``/``BitCast`` traits
`lib.rs:15-38`, `impl_cast` `lib.rs:40-88`, dyn registry `lib.rs:135-161` — 22
pairs — plus bool->f32 `boolean_cast.rs:8-75` and u32->f32 bitcast `lib.rs:187-192`).

Semantics preserved (`docs/src/kernels/cast.md` caveats):

- int -> wider int: sign/zero extend; int -> narrower/same-width int: bit
  truncation (wrapping), e.g. i8 -> u8 reinterprets (-1 -> 255);
- int -> f32: exact conversion;
- f32 -> u8 (`cast/compute_shaders/f32/cast_u8.wgsl`): WGSL ``u32(f) % 256``:
  NaN -> 0, negative/underflow -> 0, > u32::MAX saturates to u32::MAX first,
  otherwise truncate toward zero; then mod 256.  XLA's float->int conversion
  saturates at the *target* width instead, so this is emulated explicitly;
- bool -> f32: 1.0 / 0.0 from the packed bits;
- bitcast u32 -> f32 (and the same-width family): bit reinterpretation via
  ``lax.bitcast_convert_type``.

Validity is cloned through every cast (`lib.rs:63-66`).
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..errors import CastingNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, register


def _target_meta(avs, params):
    return [(params["to"], avs[0].length)]


@register("cast", out_meta=_target_meta)
def _cast_impl(a: AV, to: dt.ArrowType) -> AV:
    src, dst = a.dtype, to
    jdst = dt.jax_dtype(dst)
    if src is dt.ArrowType.BOOL:
        mask = B.unpack_bits(a.data)  # padded bools
        out = mask.astype(jdst)
        return AV(out, a.validity, a.length, dst)
    x = a.data
    if dt.is_float(src) and dt.is_integer(dst):
        # WGSL u32(f)/i32(f): trunc toward zero, saturate at 32-bit bounds,
        # NaN -> 0; then truncate to the target width (mod 2^w).
        x64 = jnp.nan_to_num(x.astype(jnp.float64), nan=0.0, posinf=1e18, neginf=-1e18)
        lo, hi = (0.0, 4294967295.0) if not dt.is_signed(dst) else (-2147483648.0, 2147483647.0)
        xi = jnp.trunc(jnp.clip(x64, lo, hi)).astype(jnp.int64)
        out = xi.astype(jdst)  # int64 -> target wraps mod 2^w
        return AV(out, a.validity, a.length, dst)
    out = x.astype(jdst)  # int<->int wrap/extend; int->float exact; float->float
    return AV(out, a.validity, a.length, dst)


@register("bitcast", out_meta=_target_meta)
def _bitcast_impl(a: AV, to: dt.ArrowType) -> AV:
    if dt.bit_width(a.dtype) != dt.bit_width(to):
        raise CastingNotSupported(
            f"bitcast requires equal widths: {a.dtype.value} -> {to.value}"
        )
    out = lax.bitcast_convert_type(a.data, dt.jax_dtype(to))
    return AV(out, a.validity, a.length, to)


# -- registered cast pairs: the reference's 22 + bool->f32 (`lib.rs:135-161`),
#    extended to the full closure of sensible numeric pairs.
_A = dt.ArrowType
_REFERENCE_PAIRS = {
    (_A.INT8, _A.UINT8), (_A.INT8, _A.UINT16), (_A.INT8, _A.UINT32),
    (_A.INT8, _A.INT16), (_A.INT8, _A.INT32), (_A.INT8, _A.FLOAT32),
    (_A.INT16, _A.INT32), (_A.INT16, _A.UINT16), (_A.INT16, _A.UINT32),
    (_A.INT16, _A.FLOAT32),
    (_A.UINT8, _A.UINT16), (_A.UINT8, _A.UINT32), (_A.UINT8, _A.INT8),
    (_A.UINT8, _A.INT16), (_A.UINT8, _A.INT32), (_A.UINT8, _A.FLOAT32),
    (_A.UINT16, _A.UINT32), (_A.UINT16, _A.INT16), (_A.UINT16, _A.INT32),
    (_A.UINT16, _A.FLOAT32),
    (_A.FLOAT32, _A.UINT8),
    (_A.BOOL, _A.FLOAT32),
}

_NUMERIC = {
    _A.UINT8, _A.UINT16, _A.UINT32, _A.UINT64,
    _A.INT8, _A.INT16, _A.INT32, _A.INT64,
    _A.FLOAT32, _A.FLOAT64, _A.DATE32,
}


def _cast_supported(src: dt.ArrowType, dst: dt.ArrowType) -> bool:
    if (src, dst) in _REFERENCE_PAIRS:
        return True
    if src is _A.BOOL:
        return dst in _NUMERIC
    return src in _NUMERIC and dst in _NUMERIC


def cast(a, to, pipeline=None):
    """Cast `a` to dtype `to` (ArrowType or DataType)."""
    to = to.arrow if isinstance(to, dt.DataType) else to
    if not _cast_supported(a.dtype, to):
        raise CastingNotSupported(f"cast {a.dtype.value} -> {to.value} not supported")
    if a.dtype is to:
        return a.clone() if pipeline is None else a
    return dispatch("cast", [a], params={"to": to}, pipeline=pipeline)


def cast_op(a, to, pipeline):
    return cast(a, to, pipeline)


cast_dyn = cast
cast_op_dyn = cast_op


def bitcast(a, to, pipeline=None):
    to = to.arrow if isinstance(to, dt.DataType) else to
    if a.dtype is _A.BOOL or to is _A.BOOL:
        raise CastingNotSupported("bitcast involving bool not supported")
    if dt.bit_width(a.dtype) != dt.bit_width(to):
        raise CastingNotSupported(
            f"bitcast requires equal widths: {a.dtype.value} -> {to.value}"
        )
    if a.dtype is to:
        return a.clone() if pipeline is None else a
    return dispatch("bitcast", [a], params={"to": to}, pipeline=pipeline)


def bitcast_op(a, to, pipeline):
    return bitcast(a, to, pipeline)


bitcast_dyn = bitcast
bitcast_op_dyn = bitcast_op
