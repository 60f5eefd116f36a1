"""Comparison kernels: eq/gt/gteq/lt/lteq -> BooleanArray; elementwise min/max.

Redesign of `crates/compare/` (traits `lib.rs:41-83`,
blanket impl `lib.rs:142-172`, dyn registry `lib.rs:199-334`).  The reference's
bit-packing via workgroup ``atomicOr`` into ``local_set_bits``
(`compare/compute_shaders/f32/cmp.wgsl:14-31`) becomes a reshape + shift-dot pack
that XLA fuses with the compare itself — no atomics.

Semantics: NaN compares false for every predicate (IEEE, tested by
`compare/src/f32.rs:18-64`); comparing a null -> null (validity AND,
`lib.rs:99-103`).  Covers all 8 reference dtypes + date32 (+64-bit extensions).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import dtypes as dt
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, merged_validity, register, scalar_data

_CMP_FNS = {
    "eq": jnp.equal,
    "gt": jnp.greater,
    "gteq": jnp.greater_equal,
    "lt": jnp.less,
    "lteq": jnp.less_equal,
}

_MINMAX_FNS = {"min": jnp.minimum, "max": jnp.maximum}

_CMP_DTYPES = {
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


def _bool_meta(avs, params):
    first = next(a for a in avs if not a.is_scalar)
    return [(dt.ArrowType.BOOL, first.length)]


def _make_kernels():
    for name, fn in _CMP_FNS.items():

        def _impl(a: AV, b: AV, _fn=fn) -> AV:
            mask = _fn(a.data, b.data)
            words = B.mask_tail(B.pack_bits(mask), a.length)
            return AV(words, merged_validity(a, b), a.length, dt.ArrowType.BOOL)

        def _scalar_impl(a: AV, b: AV, _fn=fn) -> AV:
            mask = _fn(a.data, scalar_data(b))
            words = B.mask_tail(B.pack_bits(mask), a.length)
            return AV(words, a.validity, a.length, dt.ArrowType.BOOL)

        register(name, out_meta=_bool_meta)(_impl)
        register(f"{name}_scalar", out_meta=_bool_meta)(_scalar_impl)

    for name, fn in _MINMAX_FNS.items():

        def _mm(a: AV, b: AV, _fn=fn) -> AV:
            return AV(_fn(a.data, b.data), merged_validity(a, b), a.length, a.dtype)

        register(name)(_mm)


_make_kernels()


def _check(op, *arrays):
    for a in arrays:
        if a.dtype not in _CMP_DTYPES:
            raise OperationNotSupported(f"{op} not supported for {a.dtype.value}")


def _make_api(name):
    def array_fn(a, b, pipeline=None):
        _check(name, a, b)
        return dispatch(name, [a, b], pipeline=pipeline)

    def scalar_fn(a, value, pipeline=None):
        from .arithmetic import _coerce_scalar

        _check(name, a)
        return dispatch(f"{name}_scalar", [a, _coerce_scalar(a, value)], pipeline=pipeline)

    return array_fn, scalar_fn


for _name in list(_CMP_FNS) + list(_MINMAX_FNS):
    _array_fn, _scalar_fn = _make_api(_name)
    globals()[_name] = _array_fn
    globals()[f"{_name}_op"] = lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline)
    globals()[f"{_name}_dyn"] = _array_fn
    globals()[f"{_name}_op_dyn"] = lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline)
    globals()[f"{_name}_scalar"] = _scalar_fn
    globals()[f"{_name}_scalar_op"] = (
        lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline)
    )

# dyn aliases matching the reference naming (`dyn_minmax!` lib.rs:304-334)
min_array_dyn = globals()["min"]
max_array_dyn = globals()["max"]
min_array_op_dyn = globals()["min_op"]
max_array_op_dyn = globals()["max_op"]
