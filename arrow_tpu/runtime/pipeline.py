"""Lazy compute pipeline: record ops, trace once, run as ONE fused XLA program.

Redesign of ``ArrowComputePipeline``
(`crates/array/src/gpu_utils/compute_pipeline.rs:8-12`): the
reference appends one compute pass per op to a single ``CommandEncoder`` and
submits once in ``finish()`` (`compute_pipeline.rs:259-273`), which amortizes
launch overhead but cannot fuse kernels.  Here ``record`` appends a node to an
expression graph and ``finish()`` traces the whole graph into a single jitted XLA
program — XLA then *fuses* the elementwise chain (e.g. add + mul + validity-AND
become one HBM pass), which is strictly stronger than command-buffer batching.

Compiled programs are cached by graph signature (op names, metas, params), the
analog of the reference's pipeline cache (`gpu_device.rs:145-168`).

Usage (mirrors `examples/simple.rs:45-73`):

    pipe = ComputePipeline()
    r1 = add_scalar_op(lhs, 3.0, pipe)
    r2 = mul_scalar_op(r1, 2.0, pipe)
    pipe.finish()           # one XLA dispatch
    r2.values()
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Optional, Sequence

import jax

from .. import dtypes as dt
from .device import Device, default_device


class LazyArray:
    """Handle for a not-yet-computed pipeline result.

    Before ``finish()`` it only exposes static metadata (dtype, length); after,
    it delegates every attribute to the bound concrete array, so it can be used
    exactly like the array it became (≙ the reference returning typed arrays whose
    buffers are filled when the encoder is submitted).
    """

    def __init__(self, pipeline: "ComputePipeline", node_id: int, dtype: dt.ArrowType, length: int):
        self._pipeline = pipeline
        self._node_id = node_id
        self.dtype = dtype
        self._length = length
        self._bound = None

    # -- static meta ---------------------------------------------------------

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    @property
    def is_bound(self) -> bool:
        return self._bound is not None

    def bound(self) -> "ArrowArrayBase":
        if self._bound is None:
            raise RuntimeError(
                "LazyArray used before ComputePipeline.finish(); results are only "
                "available after the pipeline is submitted"
            )
        return self._bound

    def _bind(self, arr) -> None:
        self._bound = arr

    def __getattr__(self, name):
        # only called when normal lookup fails -> delegate to the bound array
        return getattr(self.bound(), name)

    def __repr__(self) -> str:
        if self._bound is not None:
            return repr(self._bound)
        return f"LazyArray(dtype={self.dtype.value}, len={self._length}, pending)"


@dataclasses.dataclass
class _Node:
    op: str
    # each input is ("node", node_id) | ("input", input_idx) | ("scalar", input_idx)
    inputs: tuple
    params: tuple  # sorted (key, value) pairs, hashable
    out_meta: tuple  # ((dtype, length), ...)
    out_ids: tuple  # node output slot ids


@functools.lru_cache(maxsize=None)
def _compile_graph(signature: tuple):
    """Build + jit the whole-graph function for a structural signature.

    Only `live_ids` (handles still referenced by user code) become program
    outputs; dropped intermediates stay internal so XLA fuses them away entirely
    — e.g. ``mul_scalar_op(add_scalar_op(a, s, p), t, p)`` lowers to a single
    fused HBM pass.
    """
    from ..ops.kernel import AV, get_op

    nodes, input_metas, live_ids = signature

    def fn(in_bufs):
        env: dict[int, AV] = {}
        for node in nodes:
            op, inputs, params, out_meta, out_ids = node
            avs = []
            for kind, idx in inputs:
                if kind == "node":
                    avs.append(env[idx])
                else:  # graph input (array or scalar)
                    (d, v), (dtype, length) = in_bufs[idx], input_metas[idx]
                    avs.append(AV(d, v, length, dtype))
            outs = get_op(op).impl(*avs, **dict(params))
            if isinstance(outs, AV):
                outs = (outs,)
            for oid, o in zip(out_ids, outs):
                env[oid] = o
        return {oid: (env[oid].data, env[oid].validity) for oid in live_ids}

    return jax.jit(fn)


class ComputePipeline:
    """Records ops over arrays/handles; ``finish()`` compiles+runs the graph."""

    def __init__(self, device: Optional[Device] = None):
        self.device = device or default_device()
        self._nodes: list[_Node] = []
        self._inputs: list = []  # concrete (data, validity) buffer pairs
        self._input_meta: list = []  # (dtype, length) per input
        self._input_ids: dict[int, int] = {}  # id(array) -> input idx
        self._handles: list[tuple[int, weakref.ref]] = []  # (node_id, weak handle)
        self._next_slot = 0
        self._finished = False

    # -- recording -----------------------------------------------------------

    def _input_ref(self, arr) -> tuple:
        from ..array.array import ArrowArrayBase
        from ..ops.kernel import AV

        if isinstance(arr, LazyArray):
            if arr._pipeline is self and not arr.is_bound:
                return ("node", arr._node_id)
            arr = arr.bound()
        if isinstance(arr, AV):  # scalar operand
            idx = len(self._inputs)
            self._inputs.append((arr.data, arr.validity))
            self._input_meta.append((arr.dtype, arr.length))
            return ("input", idx)
        assert isinstance(arr, ArrowArrayBase), type(arr)
        key = id(arr)
        if key not in self._input_ids:
            idx = len(self._inputs)
            self._inputs.append((arr.data, arr.validity))
            self._input_meta.append((arr.dtype, arr.length))
            self._input_ids[key] = idx
        return ("input", self._input_ids[key])

    def record(self, op_name: str, operands: Sequence[Any], params: dict):
        """Append an op; returns LazyArray handle(s) (≙ appending a compute pass,
        `compute_pipeline.rs:24-256`)."""
        from ..ops.kernel import AV, get_op

        if self._finished:
            raise RuntimeError("pipeline already finished")
        opdef = get_op(op_name)
        in_refs = tuple(self._input_ref(o) for o in operands)

        metas = [AV(None, None, o.length, o.dtype) for o in operands]
        out_meta = tuple(opdef.out_meta(metas, params))

        out_ids = tuple(self._next_slot + i for i in range(len(out_meta)))
        self._next_slot += len(out_meta)
        pkey = tuple(sorted(params.items(), key=lambda kv: kv[0]))
        self._nodes.append(_Node(op_name, in_refs, pkey, out_meta, out_ids))

        handles = [
            LazyArray(self, oid, dtype, length)
            for oid, (dtype, length) in zip(out_ids, out_meta)
        ]
        for h in handles:
            self._handles.append((h._node_id, weakref.ref(h)))
        return handles[0] if len(handles) == 1 else handles

    # -- submission ----------------------------------------------------------

    def finish(self) -> None:
        """Trace + compile + run the recorded graph once; bind all handles
        (≙ `queue.submit(encoder.finish())`, `compute_pipeline.rs:259-273`)."""
        from ..array.array import make_array

        if self._finished:
            return
        self._finished = True
        if not self._nodes:
            return
        live = [(oid, ref()) for oid, ref in self._handles]
        live = [(oid, h) for oid, h in live if h is not None]
        # a node consumed by a later node may have a dead handle: safe to drop.
        live_ids = tuple(sorted({oid for oid, _ in live}))
        signature = (
            tuple(
                (n.op, n.inputs, n.params, n.out_meta, n.out_ids)
                for n in self._nodes
            ),
            tuple(self._input_meta),
            live_ids,
        )
        fn = _compile_graph(signature)
        from ..config import config

        if config.profile:
            from . import profiler

            out = profiler.timed_call(
                f"pipeline[{len(self._nodes)} ops]", fn, tuple(self._inputs)
            )
        else:
            out = fn(tuple(self._inputs))
        meta_by_id = {}
        for n in self._nodes:
            for oid, m in zip(n.out_ids, n.out_meta):
                meta_by_id[oid] = m
        for oid, handle in live:
            data, validity = out[oid]
            dtype, length = meta_by_id[oid]
            handle._bind(make_array(data, validity, length, dtype, self.device))

    def __enter__(self) -> "ComputePipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finish()
