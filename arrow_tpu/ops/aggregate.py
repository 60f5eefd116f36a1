"""Aggregation kernels: sum (+ min/max/count extensions).

Redesign of `crates/arithmetic/src/aggregate_kernels.rs`:
the reference's multi-pass workgroup tree reduction (shared-memory 256 -> 1 per
group, host loop relaunching until one element remains, `aggregate_kernels.rs:24-52`,
shader `arithmetic/compute_shaders/f32/aggregate.wgsl`) is exactly what XLA's
reduce emitter generates natively, so ``sum`` lowers to a single fused
`jnp.sum` with padding lanes masked (the reference guards with ``arrayLength``).

Semantics preserved: returns a 1-element array of the same dtype; the null
bitmap is IGNORED (the reference sums the raw data buffer — nulls contribute
their stored default 0).  Reference coverage: f32/u32/i32 (`Sum32Bit`
`aggregate_kernels.rs:20-22`); extended here to all numeric dtypes.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import pad_len
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, register

_SUM_DTYPES = {
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
}


def _one_meta(avs, params):
    return [(avs[0].dtype, 1)]


def _masked(a: AV, fill):
    """Zero/neutralize padding lanes (≙ the shader's arrayLength guard)."""
    n = a.data.shape[0]
    if n == a.length:
        return a.data
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    return jnp.where(idx < a.length, a.data, jnp.asarray(fill, a.data.dtype))


def _scalar_out(value, dtype: dt.ArrowType):
    return jnp.zeros(pad_len(1), dt.jax_dtype(dtype)).at[0].set(value)


@register("sum", out_meta=_one_meta)
def _sum_impl(a: AV) -> AV:
    total = jnp.sum(_masked(a, 0), dtype=a.jax_dtype)
    return AV(_scalar_out(total, a.dtype), None, 1, a.dtype)


@register("agg_min", out_meta=_one_meta)
def _min_impl(a: AV) -> AV:
    if dt.is_float(a.dtype):
        fill = jnp.inf
    else:
        fill = jnp.iinfo(dt.jax_dtype(a.dtype)).max
    m = jnp.min(_masked(a, fill))
    return AV(_scalar_out(m, a.dtype), None, 1, a.dtype)


@register("agg_max", out_meta=_one_meta)
def _max_impl(a: AV) -> AV:
    if dt.is_float(a.dtype):
        fill = -jnp.inf
    else:
        fill = jnp.iinfo(dt.jax_dtype(a.dtype)).min
    m = jnp.max(_masked(a, fill))
    return AV(_scalar_out(m, a.dtype), None, 1, a.dtype)


def _check(name, a):
    if a.dtype not in _SUM_DTYPES and not (
        a.dtype is dt.ArrowType.DATE32 and name != "sum"
    ):
        raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")


def sum_(a, pipeline=None):
    """Sum all elements -> 1-element array (≙ ``Sum::sum``
    `aggregate_kernels.rs:8-13`). Nulls are NOT skipped (reference behavior)."""
    _check("sum", a)
    return dispatch("sum", [a], pipeline=pipeline)


def sum_op(a, pipeline):
    return sum_(a, pipeline)


sum_dyn = sum_
sum_op_dyn = sum_op


def min_reduce(a, pipeline=None):
    _check("min", a)
    return dispatch("agg_min", [a], pipeline=pipeline)


def max_reduce(a, pipeline=None):
    _check("max", a)
    return dispatch("agg_max", [a], pipeline=pipeline)
