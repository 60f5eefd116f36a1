"""Filter / compaction operator: predicate mask -> densely packed selected rows.

Net-new north-star operator (BASELINE.md: "filter: predicate + null-bitmap
compaction, 100M rows, 1-99% selectivity, >=80% HBM roofline").  The reference
only provides the seeds: `take` (gather) and bit-packed masks (SURVEY.md §3.6
"these are the seeds of the build's filter/compaction operator").

Design: ONE fused XLA program computes
  select = mask_value_words & mask_validity_words   (null mask rows -> dropped,
                                                     Arrow filter semantics)
  count  = popcount(select)
  out    = stable partition: multi-operand stable sort on the 1-bit select key,
           moving selected rows (data + validity bits together) to the front in
           original order.
The result buffer has input capacity; only the (host-synced) count is the
logical length — this keeps the compiled program shape-stable across
selectivities, so the 1-99% selectivity sweep reuses one executable.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import jax
import jax.lax as lax
import jax.numpy as jnp

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..array.boolean import BooleanArray
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B


def _select_words(mask_words, mask_validity):
    return mask_words if mask_validity is None else mask_words & mask_validity


@functools.lru_cache(maxsize=None)
def _filter_program(n_padded: int, length: int, jdtype_str: str, has_validity: bool, is_bool: bool):
    jdtype = jnp.dtype(jdtype_str)

    from ..utils.scans import stable_partition

    def run(data, validity, mask_words, mask_validity):
        select = _select_words(mask_words, mask_validity)
        bools = B.unpack_bits(select)  # padded length (bits >= length are 0)
        count = jnp.sum(bools, dtype=jnp.uint32)
        n = bools.shape[0]
        vals = B.unpack_bits(data) if is_bool else data
        operands = [vals]
        if has_validity:
            operands.append(B.unpack_bits(validity))
        parts = stable_partition(bools, operands)
        live = lax.broadcasted_iota(jnp.uint32, (n,), 0) < count
        if is_bool:
            out = B.pack_bits(parts[0] & live)
        else:
            out = jnp.where(live, parts[0], jnp.zeros_like(parts[0]))
        v = B.pack_bits(parts[1] & live) if has_validity else None
        return count, out, v

    return jax.jit(run)


def filter_indices(mask: BooleanArray) -> Tuple[ArrowArrayBase, int]:
    """Selected row indices (UInt32Array) + count; null mask rows excluded."""
    from ..utils.scans import stable_partition

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(words, validity, n):
        select = words if validity is None else words & validity
        bools = B.unpack_bits(select)
        count = jnp.sum(bools, dtype=jnp.uint32)
        n_pad = bools.shape[0]
        rows = lax.broadcasted_iota(jnp.uint32, (n_pad,), 0)
        (sel_rows,) = stable_partition(bools, [rows])
        live = rows < count
        out = jnp.where(live, sel_rows, jnp.uint32(0))
        return count, out

    count, out = run(mask.data, mask.validity, mask.length)
    k = int(count)
    return make_array(out, None, k, dt.ArrowType.UINT32, mask.device), k


@functools.lru_cache(maxsize=None)
def _batch_filter_program(signature):
    """One multi-operand stable partition carrying every column of a batch.

    signature: tuple of (is_bool, has_validity) per column.  A single fused
    sort moves all columns at once, with no per-column gathers.
    """
    from ..utils.scans import stable_partition

    def run(mask_words, mask_validity, *flat_cols):
        select = _select_words(mask_words, mask_validity)
        bools = B.unpack_bits(select)
        count = jnp.sum(bools, dtype=jnp.uint32)
        n = bools.shape[0]
        operands = []
        for (is_bool, has_validity), pair in zip(signature, _pairs(flat_cols)):
            data_w, valid_w = pair
            operands.append(B.unpack_bits(data_w) if is_bool else data_w)
            operands.append(B.unpack_bits(valid_w) if has_validity else None)
        dense = [o for o in operands if o is not None]
        parts = iter(stable_partition(bools, dense))
        live = lax.broadcasted_iota(jnp.uint32, (n,), 0) < count
        outs = []
        for (is_bool, has_validity) in signature:
            d = next(parts)
            if is_bool:
                outs.append(B.pack_bits(d & live))
            else:
                outs.append(jnp.where(live, d, jnp.zeros_like(d)))
            outs.append(B.pack_bits(next(parts) & live) if has_validity else None)
        return count, outs

    return jax.jit(run)


def _pairs(flat):
    it = iter(flat)
    return list(zip(it, it))


def _filter_batch(batch: RecordBatch, mask: BooleanArray) -> RecordBatch:
    cols = batch.columns()
    signature = tuple(
        (c.dtype is dt.ArrowType.BOOL, c.validity is not None) for c in cols.values()
    )
    flat = []
    for c in cols.values():
        flat.extend((c.data, c.validity))
    prog = _batch_filter_program(signature)
    count, outs = prog(mask.data, mask.validity, *flat)
    k = int(count)
    out_cols = {}
    for (name, c), d, v in zip(cols.items(), outs[::2], outs[1::2]):
        out_cols[name] = make_array(d, v, k, c.dtype, c.device)
    return RecordBatch(out_cols)


def filter(
    data: Union[ArrowArrayBase, RecordBatch],
    mask: BooleanArray,
    method: str = "auto",
) -> Union[ArrowArrayBase, RecordBatch]:
    """Compact rows where mask is true (and valid).

    method: "auto" or "sort" — both run the stable-partition XLA program.
    For a RecordBatch, every column rides one fused sort.
    """
    if method not in ("auto", "sort"):
        raise OperationNotSupported(f"unknown filter method {method!r}")
    if mask.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("filter mask must be a BooleanArray")
    if len(data) != len(mask):
        raise OperationNotSupported("filter requires equal lengths")
    if isinstance(data, RecordBatch):
        return _filter_batch(data, mask)

    is_bool = data.dtype is dt.ArrowType.BOOL
    prog = _filter_program(
        int(data.data.shape[0]),
        data.length,
        str(jnp.dtype(data.data.dtype)),
        data.validity is not None,
        is_bool,
    )
    count, out, v = prog(data.data, data.validity, mask.data, mask.validity)
    k = int(count)
    return make_array(out, v, k, data.dtype, data.device)


def filter_count(mask: BooleanArray) -> int:
    """Number of rows a filter would select."""
    select = _select_words(mask.data, mask.validity)
    return int(B.popcount_words(select))
