"""Sort operators: stable sort / argsort / sort-by-key with payload columns.

Net-new north-star operator (BASELINE.md: "radix sort: 1B-row u32/i64 key +
payload, stable multi-pass LSB").  The reference has no sort; its multi-pass
reduction (SURVEY.md §3.5) is the compositional seed.

Every sort is `jax.lax.sort(..., is_stable=True)`, XLA's fused
multi-operand sort.

Null ordering: valid rows first (stable), null rows last — implemented by
sorting on a (is_null, key) compound, with only the row payload permuted.
"""

from __future__ import annotations

import functools
from typing import Union

import jax
import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B

_SORTABLE = {
    dt.ArrowType.UINT8, dt.ArrowType.UINT16, dt.ArrowType.UINT32, dt.ArrowType.UINT64,
    dt.ArrowType.INT8, dt.ArrowType.INT16, dt.ArrowType.INT32, dt.ArrowType.INT64,
    dt.ArrowType.FLOAT32, dt.ArrowType.FLOAT64, dt.ArrowType.DATE32,
}


def _sort_keys(data, validity, length, descending: bool):
    """Build compound sort keys: (padding/null last, key order)."""
    n = data.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (n,), 0)
    in_range = idx < length
    if validity is not None:
        valid = B.unpack_bits(validity) & in_range
    else:
        valid = in_range
    # primary key: 0 = real value, 1 = null, 2 = padding (stays at the end)
    rank = jnp.where(in_range, jnp.where(valid, 0, 1), 2).astype(jnp.int32)
    key = lax.select(valid, data, jnp.zeros_like(data))  # neutralize NaN/garbage
    if descending:
        if jnp.issubdtype(data.dtype, jnp.floating):
            key = -key
        else:
            key = ~key if jnp.issubdtype(data.dtype, jnp.unsignedinteger) else jnp.invert(key)
    return rank, key


def _check_method(method: str) -> None:
    if method not in ("auto", "xla"):
        raise OperationNotSupported(f"unknown sort method {method!r}")


@functools.partial(jax.jit, static_argnums=(2, 3))
def _argsort_program(data, validity, length, descending, *payloads):
    rank, key = _sort_keys(data, validity, length, descending)
    n = data.shape[0]
    rows = lax.broadcasted_iota(jnp.uint32, (n,), 0)
    operands = [rank, key, rows, *payloads]
    out = lax.sort(operands, num_keys=2, is_stable=True)
    return out[1:]  # sorted key, row order, sorted payloads


def argsort(a: ArrowArrayBase, descending: bool = False) -> ArrowArrayBase:
    """Stable permutation (UInt32Array) sorting `a` (nulls last)."""
    if a.dtype not in _SORTABLE:
        raise OperationNotSupported(f"sort not supported for {a.dtype.value}")
    outs = _argsort_program(a.data, a.validity, a.length, descending)
    order = outs[1]
    return make_array(order, None, a.length, dt.ArrowType.UINT32, a.device)


def sort(
    a: ArrowArrayBase, descending: bool = False, method: str = "auto"
) -> ArrowArrayBase:
    """Stable sort of one column, nulls last.

    method: "auto" or "xla" — both run `lax.sort`.
    """
    _check_method(method)
    if a.dtype not in _SORTABLE:
        raise OperationNotSupported(f"sort not supported for {a.dtype.value}")
    if a.validity is None and not descending:
        sorted_key, _ = _argsort_program(a.data, None, a.length, descending)
        return make_array(sorted_key, None, a.length, a.dtype, a.device)
    # nulls or descending: permute data (+validity) by the sort order — the
    # program's key operand is order-transformed, so it can't be returned as-is
    from ..kernels import take as _take

    return _take(a, argsort(a, descending))


def sort_by_key(
    keys: ArrowArrayBase,
    payload: Union[ArrowArrayBase, RecordBatch, None] = None,
    descending: bool = False,
    method: str = "auto",
):
    """Stable key+payload sort (the 1B-row bench shape: key column + payload).

    method: "auto" or "xla" — one fused `lax.sort` for simple payloads, else
    a permutation gather.  Returns (sorted_keys, sorted_payload).
    """
    _check_method(method)
    if keys.dtype not in _SORTABLE:
        raise OperationNotSupported(f"sort not supported for {keys.dtype.value}")
    if isinstance(payload, ArrowArrayBase):
        simple = payload.validity is None and payload.dtype is not dt.ArrowType.BOOL
        if simple:
            outs = _argsort_program(
                keys.data, keys.validity, keys.length, descending, payload.data
            )
            sk, order, sp = outs
            out_keys = _wrap_sorted_keys(keys, sk, order, descending)
            return out_keys, make_array(sp, None, payload.length, payload.dtype, payload.device)
        order_arr = argsort(keys, descending)
        from ..kernels import take as _take

        return _take(keys, order_arr), _take(payload, order_arr)
    if isinstance(payload, RecordBatch):
        order_arr = argsort(keys, descending)
        from ..kernels import take as _take

        return _take(keys, order_arr), payload.take(order_arr)
    return sort(keys, descending), None


def lex_sort(
    keys: "list[ArrowArrayBase]",
    payload: Union[ArrowArrayBase, RecordBatch, None] = None,
    descending: bool = False,
):
    """Lexicographic multi-key stable sort (first key most significant).

    Extension beyond the reference (which has no sort at all); one fused
    `lax.sort` carries all key columns and the row permutation.
    """
    if not keys:
        raise OperationNotSupported("lex_sort needs at least one key column")
    for k in keys:
        if k.dtype not in _SORTABLE or k.validity is not None:
            raise OperationNotSupported("lex_sort keys must be non-null primitives")
    n = keys[0].length
    npad = keys[0].data.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (npad,), 0)
    rank = jnp.where(idx < n, 0, 1).astype(jnp.int32)
    ops = [rank]
    for k in keys:
        kd = k.data
        if descending:
            if jnp.issubdtype(kd.dtype, jnp.floating):
                kd = -kd
            else:
                kd = ~kd
        ops.append(kd)
    rows = lax.broadcasted_iota(jnp.uint32, (npad,), 0)
    ops.append(rows)
    out = lax.sort(ops, num_keys=1 + len(keys), is_stable=True)
    order = make_array(out[-1], None, n, dt.ArrowType.UINT32, keys[0].device)
    from ..kernels import take as _take

    sorted_keys = [_take(k, order) for k in keys]
    if payload is None:
        return sorted_keys, None, order
    sorted_payload = (
        payload.take(order) if isinstance(payload, RecordBatch) else _take(payload, order)
    )
    return sorted_keys, sorted_payload, order


def _wrap_sorted_keys(keys, sorted_data, order, descending):
    if keys.validity is None and not descending:
        return make_array(sorted_data, None, keys.length, keys.dtype, keys.device)
    from ..kernels import take as _take

    return _take(keys, make_array(order, None, keys.length, dt.ArrowType.UINT32, keys.device))
