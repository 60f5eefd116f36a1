"""Math kernels: abs, sqrt, cbrt, exp, exp2, log, log2, power.

Redesign of `crates/math/` (traits `lib.rs:37-136`,
impls `lib.rs:195-237`, dyn registry `lib.rs:261-348`; shader entry points in
`math/compute_shaders/f32/floatunary.wgsl`).

Semantics preserved:

- ``cbrt`` is sign-preserving: ``-pow(-x, 1/3)`` for x < 0
  (`floatunary.wgsl:46-53`);
- integer ``power`` is the WGSL loop (`i32/binary.wgsl:15-29`): wrapping repeated
  multiply for exponent >= 0; for exponent < 0 the loop repeatedly integer-divides
  1 by x, whose closed form is: x == 0 -> 1 (WGSL div-by-zero yields the
  dividend), |x| == 1 -> x^(|p| & 1 ? 1 : 0), else 0;
- float ``power`` is IEEE ``pow``.

Reference dyn coverage: unary ops f32 (`lib.rs:261-270`); power f32 + i32
(`lib.rs:340-348`).  abs additionally has typed impls for i32.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import dtypes as dt
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, merged_validity, register

_F = {dt.ArrowType.FLOAT32, dt.ArrowType.FLOAT64}
_ABS_DTYPES = _F | {dt.ArrowType.INT8, dt.ArrowType.INT16, dt.ArrowType.INT32, dt.ArrowType.INT64}
_POWER_DTYPES = _F | {dt.ArrowType.INT32, dt.ArrowType.INT64}


def _cbrt(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


_UNARY_FNS = {
    "abs": jnp.abs,
    "sqrt": jnp.sqrt,
    "cbrt": _cbrt,
    "exp": jnp.exp,
    "exp2": jnp.exp2,
    "log": jnp.log,
    "log2": jnp.log2,
}


def _make_unary_kernels():
    for name, fn in _UNARY_FNS.items():

        def _impl(a: AV, _fn=fn) -> AV:
            return AV(_fn(a.data), a.validity, a.length, a.dtype)

        register(f"math_{name}")(_impl)


_make_unary_kernels()


@register("power")
def _power_impl(a: AV, b: AV) -> AV:
    x, p = a.data, b.data
    if dt.is_float(a.dtype):
        out = jnp.power(x, p)
    else:
        # wrapping repeated multiply (square-and-multiply is congruent mod 2^w)
        pos = jnp.power(x, jnp.where(p < 0, 0, p).astype(x.dtype))
        absp = jnp.where(p < 0, -p, p)
        # closed form of the WGSL negative-exponent division loop
        neg = jnp.where(
            x == 0,
            jnp.ones_like(x),
            jnp.where(
                jnp.abs(x.astype(jnp.int64)).astype(x.dtype) == 1,
                jnp.where((absp & 1) == 1, x, jnp.ones_like(x)),
                jnp.zeros_like(x),
            ),
        )
        out = jnp.where(p < 0, neg, pos)
    return AV(out, merged_validity(a, b), a.length, a.dtype)


def _check(name, a, allowed):
    if a.dtype not in allowed:
        raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")


def _make_api(name, allowed):
    def fn(a, pipeline=None):
        _check(name, a, allowed)
        return dispatch(f"math_{name}", [a], pipeline=pipeline)

    return fn


for _name in _UNARY_FNS:
    _allowed = _ABS_DTYPES if _name == "abs" else _F
    _fn = _make_api(_name, _allowed)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)


def power(a, b, pipeline=None):
    _check("power", a, _POWER_DTYPES)
    if a.dtype is not b.dtype:
        raise OperationNotSupported("power requires matching dtypes")
    return dispatch("power", [a, b], pipeline=pipeline)


def power_op(a, b, pipeline):
    return power(a, b, pipeline)


power_dyn = power
power_op_dyn = power_op
