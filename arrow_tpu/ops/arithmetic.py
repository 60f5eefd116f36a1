"""Arithmetic kernels: add/sub/mul/div/rem (array⊕array, array⊕scalar), neg, sum.

Redesign of `crates/arithmetic/` (traits
`arithmetic_kernels.rs:18-75,178-223,270-280`, impl macros `lib.rs:11-96`, dyn
registry `arithmetic_kernels.rs:122-267`): per-dtype WGSL shaders become one
dtype-generic traced kernel per op; XLA fuses the op with its validity handling.

Semantics preserved (WGSL arithmetic rules, see `docs/src/kernels` and the
reference shaders `arithmetic/compute_shaders/*/scalar.wgsl`):

- integer add/sub/mul wrap (two's complement) — XLA's native behavior;
- integer ``x / 0 == x``; ``INT_MIN / -1 == INT_MIN`` (WGSL defined results);
- integer ``x % 0 == 0``; ``INT_MIN % -1 == 0``; remainder is trunc-style
  (sign of dividend);
- float div by zero -> ±inf/NaN per IEEE; float ``%`` is trunc-style fmod;
- scalar ops clone the lhs validity (`lib.rs:32-40`); array ops AND the two
  validity bitmaps (`lib.rs:84-90`).

Dyn coverage (reference registry, which we extend to all numeric dtypes):
`add_scalar`: f32,i32,date32,u32,u16; `sub/mul/div/rem_scalar`: f32,i32,u32 (+
rem date32); `add_array`: f32,u32,i32,date32,i32⊕date32; `sub/mul/div_array`:
f32; `neg`: f32 (`arithmetic_kernels.rs:343`).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase
from ..array.scalar import Scalar
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, merged_validity, register, scalar_av, scalar_data

_NUMERIC = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.UINT32,
    dt.ArrowType.UINT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
    dt.ArrowType.DATE32,
}

_SIGNED = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
}


def _wgsl_div(x, y, dtype: dt.ArrowType):
    if dt.is_float(dtype):
        return x / y
    # WGSL-defined integer division: x/0 == x ; INT_MIN / -1 == INT_MIN
    if dt.is_signed(dtype):
        tmin = jnp.iinfo(dt.jax_dtype(dtype)).min
        bad = (y == 0) | ((x == tmin) & (y == y.dtype.type(-1)))
    else:
        bad = y == 0
    safe = jnp.where(bad, jnp.ones_like(y), y)
    return jnp.where(bad, x, jnp.divide(x, safe).astype(x.dtype))


def _wgsl_rem(x, y, dtype: dt.ArrowType):
    if dt.is_float(dtype):
        return jnp.fmod(x, y)  # trunc-style, sign of dividend (WGSL %)
    if dt.is_signed(dtype):
        tmin = jnp.iinfo(dt.jax_dtype(dtype)).min
        bad = (y == 0) | ((x == tmin) & (y == y.dtype.type(-1)))
    else:
        bad = y == 0
    safe = jnp.where(bad, jnp.ones_like(y), y)
    # jnp.fmod on ints is trunc-style (C fmod), matching WGSL %
    return jnp.where(bad, jnp.zeros_like(x), jnp.fmod(x, safe))


_FNS = {
    "add": lambda x, y, t: x + y,
    "sub": lambda x, y, t: x - y,
    "mul": lambda x, y, t: x * y,
    "div": _wgsl_div,
    "rem": _wgsl_rem,
}


def _make_kernels():
    for name, fn in _FNS.items():

        def _array_impl(a: AV, b: AV, _fn=fn) -> AV:
            out = _fn(a.data, b.data, a.dtype)
            return AV(out, merged_validity(a, b), a.length, a.dtype)

        def _scalar_impl(a: AV, b: AV, _fn=fn) -> AV:
            out = _fn(a.data, scalar_data(b), a.dtype)
            return AV(out, a.validity, a.length, a.dtype)  # clone lhs validity

        register(name)(_array_impl)
        register(f"{name}_scalar")(_scalar_impl)


_make_kernels()


@register("neg")
def _neg_impl(a: AV) -> AV:
    return AV(-a.data, a.validity, a.length, a.dtype)


# ---------------------------------------------------------------------------
# typed + dyn API (≙ trait methods + `dyn_fn!` registrations)
# ---------------------------------------------------------------------------


def _coerce_scalar(a, value) -> AV:
    if isinstance(value, AV):
        return value
    if isinstance(value, (Scalar, int, float, bool)):
        return scalar_av(value, a.dtype if not isinstance(value, Scalar) else value.dtype)
    return value  # 1-row array used as scalar


def _check(op: str, *dtypes: dt.ArrowType) -> None:
    for d in dtypes:
        if d not in _NUMERIC:
            raise OperationNotSupported(f"{op} not supported for {[x.value for x in dtypes]}")


def _make_api(name: str):
    def array_fn(a, b, pipeline=None):
        _check(name, a.dtype, b.dtype)
        return dispatch(name, [a, b], pipeline=pipeline)

    def scalar_fn(a, value, pipeline=None):
        _check(name, a.dtype)
        return dispatch(f"{name}_scalar", [a, _coerce_scalar(a, value)], pipeline=pipeline)

    def generic_dyn(a, b, pipeline=None):
        # route array-vs-scalar by operand length (≙ arithmetic_kernels.rs:101-120)
        la, lb = len(a), len(b)
        if (la == 1 and lb == 1) or (la != 1 and lb != 1):
            return array_fn(a, b, pipeline)
        if lb == 1:
            return scalar_fn(a, b, pipeline)
        return scalar_fn(b, a, pipeline)

    return array_fn, scalar_fn, generic_dyn


for _name in _FNS:
    _array_fn, _scalar_fn, _generic = _make_api(_name)
    globals()[_name] = _array_fn
    globals()[f"{_name}_op"] = lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline)
    globals()[f"{_name}_scalar"] = _scalar_fn
    globals()[f"{_name}_scalar_op"] = (
        lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline)
    )
    # dyn forms (same dispatch; Python is already dynamic over the array union)
    globals()[f"{_name}_array_dyn"] = _array_fn
    globals()[f"{_name}_array_op_dyn"] = (
        lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline)
    )
    globals()[f"{_name}_scalar_dyn"] = _scalar_fn
    globals()[f"{_name}_scalar_op_dyn"] = (
        lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline)
    )
    globals()[f"{_name}_dyn"] = _generic
    globals()[f"{_name}_op_dyn"] = lambda a, b, pipeline, _f=_generic: _f(a, b, pipeline)


def neg(a, pipeline=None):
    if a.dtype not in _SIGNED:
        raise OperationNotSupported(f"neg not supported for {a.dtype.value}")
    return dispatch("neg", [a], pipeline=pipeline)


def neg_op(a, pipeline):
    return neg(a, pipeline)


neg_dyn = neg
neg_op_dyn = neg_op
