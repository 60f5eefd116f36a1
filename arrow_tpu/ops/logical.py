"""Logical kernels: bitwise and/or/xor/not, shl/shr, any/all reductions.

Redesign of `crates/logical/` (``LogicalType``
`lib.rs:22-26`, ``Logical`` trait `lib.rs:44-78`, dyn registry `lib.rs:214-349`,
boolean impls `boolean.rs:45-146`).

- Integer dtypes: native jnp bitwise ops (wrap/width semantics are exact).
- Boolean arrays: ops run directly on the packed uint32 word buffers — the
  equivalent of the reference routing booleans through its u32 shaders
  (`boolean.rs:45-104`) — 32 rows per lane op.  ``not`` re-masks the tail so the
  bits-beyond-length invariant holds.
- Shifts take a UInt32Array of amounts (`dyn_fn_sh!` `lib.rs:85-110`); WGSL
  semantics: the value is widened to 32 bits, shifted by ``amount & 31``, then
  truncated back to the dtype width (see `logical/compute_shaders/u8/shift.wgsl`
  lane pack/unpack).  i8/i16 use arithmetic right shift on the widened value.
- ``any``/``all`` (`boolean.rs:107-146`) return host bools: ``any`` = any word
  nonzero (reference: global atomicAdd flag, `compute_shaders/u32/any.wgsl`);
  ``all`` = popcount sum == len (reference: countOneBits -> Sum -> compare).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import dtypes as dt
from ..array.boolean import BooleanArray
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, merged_validity, register

_INT_DTYPES = {
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.UINT32,
    dt.ArrowType.UINT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
}

_LOGICAL_DTYPES = _INT_DTYPES | {dt.ArrowType.BOOL}

_BIN_FNS = {
    "bitwise_and": jnp.bitwise_and,
    "bitwise_or": jnp.bitwise_or,
    "bitwise_xor": jnp.bitwise_xor,
}


def _make_kernels():
    for name, fn in _BIN_FNS.items():

        def _impl(a: AV, b: AV, _fn=fn) -> AV:
            # BOOL: packed words combine bitwise; tail bits stay 0 (0 op 0 = 0)
            return AV(_fn(a.data, b.data), merged_validity(a, b), a.length, a.dtype)

        register(name)(_impl)


_make_kernels()


@register("bitwise_not")
def _not_impl(a: AV) -> AV:
    if a.dtype is dt.ArrowType.BOOL:
        out = B.mask_tail(~a.data, a.length)
    else:
        out = ~a.data
    return AV(out, a.validity, a.length, a.dtype)


def _shift_impl_factory(left: bool):
    def _impl(a: AV, amt: AV) -> AV:
        info = dt.info(a.dtype)
        width = info.bit_width
        amount = amt.data.astype(jnp.uint32) & jnp.uint32(31)
        if width == 32 or width == 64:
            if width == 64:
                amount = amt.data.astype(jnp.uint64) & jnp.uint64(63)
            x = a.data
            out = (x << amount.astype(x.dtype)) if left else (x >> amount.astype(x.dtype))
        else:
            # widen to 32-bit, shift, truncate back (WGSL lane pack/unpack)
            wide = jnp.int32 if info.is_signed else jnp.uint32
            x = a.data.astype(wide)
            s = (x << amount.astype(wide)) if left else (x >> amount.astype(wide))
            out = s.astype(a.jax_dtype)
        return AV(out, merged_validity(a, amt), a.length, a.dtype)

    return _impl


register("bitwise_shl")(_shift_impl_factory(left=True))
register("bitwise_shr")(_shift_impl_factory(left=False))


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------


def _check(op, *arrays, allowed=_LOGICAL_DTYPES):
    for a in arrays:
        if a.dtype not in allowed:
            raise OperationNotSupported(f"{op} not supported for {a.dtype.value}")


def _make_api(name):
    def fn(a, b, pipeline=None):
        _check(name, a, b)
        if a.dtype is not b.dtype:
            raise OperationNotSupported(f"{name} requires matching dtypes")
        return dispatch(name, [a, b], pipeline=pipeline)

    return fn


for _name in _BIN_FNS:
    _fn = _make_api(_name)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, b, pipeline, _f=_fn: _f(a, b, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, b, pipeline, _f=_fn: _f(a, b, pipeline)

# operator-style aliases (reference exposes and/or/xor/not names via Logical trait)
and_ = globals()["bitwise_and"]
or_ = globals()["bitwise_or"]
xor = globals()["bitwise_xor"]


def bitwise_not(a, pipeline=None):
    _check("bitwise_not", a)
    return dispatch("bitwise_not", [a], pipeline=pipeline)


def bitwise_not_op(a, pipeline):
    return bitwise_not(a, pipeline)


bitwise_not_dyn = bitwise_not
bitwise_not_op_dyn = bitwise_not_op
not_ = bitwise_not


def bitwise_shl(a, amount, pipeline=None):
    _check("bitwise_shl", a, allowed=_INT_DTYPES)
    if amount.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("shift amounts must be a UInt32Array")
    return dispatch("bitwise_shl", [a, amount], pipeline=pipeline)


def bitwise_shr(a, amount, pipeline=None):
    _check("bitwise_shr", a, allowed=_INT_DTYPES)
    if amount.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("shift amounts must be a UInt32Array")
    return dispatch("bitwise_shr", [a, amount], pipeline=pipeline)


def bitwise_shl_op(a, amount, pipeline):
    return bitwise_shl(a, amount, pipeline)


def bitwise_shr_op(a, amount, pipeline):
    return bitwise_shr(a, amount, pipeline)


bitwise_shl_dyn = bitwise_shl
bitwise_shr_dyn = bitwise_shr
bitwise_shl_op_dyn = bitwise_shl_op
bitwise_shr_op_dyn = bitwise_shr_op


# -- reductions (blocking host results, ≙ LogicalContains boolean.rs:107-146) --


def any_(arr: BooleanArray) -> bool:
    """True if any value bit is set (nulls NOT consulted, like the reference)."""
    if arr.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("any requires a BooleanArray")
    return bool(jnp.any(arr.data != 0))


def all_(arr: BooleanArray) -> bool:
    """True if all `len` value bits are set (popcount == len)."""
    if arr.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("all requires a BooleanArray")
    return int(B.popcount_words(arr.data)) == arr.length
