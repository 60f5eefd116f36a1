"""Op execution machinery: traceable kernels, registry, eager jit cache, dispatch.

Replacement for the reference's dispatch plumbing:

- the generic ``apply_{unary,scalar,binary,ternary,broadcast}_function`` helpers
  (`crates/array/src/gpu_utils/gpu_device.rs:267-509`) become
  :class:`AV` transforms — pure functions over (data, validity) JAX buffers that can
  be traced, fused and jitted;
- the compiled-shader cache keyed by (shader source, entry point)
  (`gpu_device.rs:145-168`, `append_hashmap.rs:9-34`) becomes the eager jit cache
  keyed by (op name, input meta, static params) — XLA recompiles per shape bucket
  exactly as the reference compiles per entry point;
- every op comes in eager (``foo``) and pipelined (``foo_op``) flavors like the
  reference (`arithmetic_kernels.rs:8-27`); the pipelined flavor records into a
  :class:`~arrow_tpu.runtime.pipeline.ComputePipeline` which traces the whole op
  graph into ONE fused XLA program — the answer to the reference's
  single-command-buffer submission (`compute_pipeline.rs:259-273`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..array.scalar import Scalar
from ..errors import OperationNotSupported


class AV(NamedTuple):
    """An array value during tracing: buffers are (possibly traced) jnp arrays,
    `length`/`dtype` are static Python values.

    For BOOL dtype, `data` is the packed uint32 word buffer.  A scalar operand is
    an AV with 0-d `data` and length -1 (see :func:`scalar_av`).
    """

    data: jnp.ndarray
    validity: Optional[jnp.ndarray]
    length: int
    dtype: dt.ArrowType

    @property
    def is_scalar(self) -> bool:
        return self.length == -1

    @property
    def jax_dtype(self):
        return dt.jax_dtype(self.dtype)


def scalar_av(value: Union[Scalar, int, float, bool, np.generic], dtype: dt.ArrowType) -> AV:
    """Build a scalar AV with a concrete 0-d device buffer."""
    v = value.value if isinstance(value, Scalar) else value
    buf = jnp.asarray(v, dtype=dt.jax_dtype(dtype) if dtype is not dt.ArrowType.BOOL else jnp.bool_)
    return AV(buf, None, -1, dtype)


def array_av(arr: ArrowArrayBase) -> AV:
    return AV(arr.data, arr.validity, arr.length, arr.dtype)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpDef:
    """A registered kernel: `impl` maps input AVs -> output AV(s) under trace;
    `out_meta` derives output (dtype, length) without executing (for pipeline
    handles)."""

    name: str
    impl: Callable[..., Any]
    out_meta: Callable[..., Sequence[Tuple[dt.ArrowType, int]]]


_REGISTRY: dict[str, OpDef] = {}


def register(name: str, out_meta: Optional[Callable] = None):
    """Decorator registering an AV-transform kernel under `name`.

    Default out_meta: single output with dtype/length of the first array input.
    """

    def deco(impl):
        om = out_meta
        if om is None:

            def om(avs, params):  # noqa: E306
                first = next(a for a in avs if not a.is_scalar)
                return [(first.dtype, first.length)]

        _REGISTRY[name] = OpDef(name, impl, om)
        return impl

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise OperationNotSupported(f"unknown op {name!r}") from None


# ---------------------------------------------------------------------------
# Eager execution (jit-cached)
# ---------------------------------------------------------------------------


def _params_key(params: dict) -> tuple:
    return tuple(sorted(params.items(), key=lambda kv: kv[0]))


@functools.lru_cache(maxsize=None)
def _eager_jit(op_name: str, meta_key: tuple, pkey: tuple):
    opdef = _REGISTRY[op_name]
    params = dict(pkey)

    def fn(bufs):
        avs = tuple(
            AV(d, v, length, dtype)
            for (d, v), (dtype, length) in zip(bufs, meta_key)
        )
        outs = opdef.impl(*avs, **params)
        if isinstance(outs, AV):
            outs = (outs,)
        return tuple((o.data, o.validity) for o in outs), tuple(
            (o.dtype, o.length) for o in outs
        )

    # out metas are static; jit only the buffer part.
    jfn = jax.jit(lambda bufs: fn(bufs)[0])

    def run(bufs):
        out_bufs = jfn(bufs)
        # re-derive static metas via the (cheap) out_meta fn
        avs_meta = [AV(None, None, length, dtype) for (dtype, length) in meta_key]
        metas = opdef.out_meta(avs_meta, params)
        return out_bufs, metas

    return run


def execute(op_name: str, avs: Sequence[AV], params: Optional[dict] = None):
    """Run a registered op eagerly; returns list of AV with concrete buffers."""
    from ..config import config

    params = params or {}
    meta_key = tuple((a.dtype, a.length) for a in avs)
    run = _eager_jit(op_name, meta_key, _params_key(params))
    bufs = tuple((a.data, a.validity) for a in avs)
    if config.profile:
        from ..runtime import profiler

        out_bufs, metas = profiler.timed_call(op_name, run, bufs)
    else:
        out_bufs, metas = run(bufs)
    return [
        AV(d, v, length, dtype)
        for (d, v), (dtype, length) in zip(out_bufs, metas)
    ]


# ---------------------------------------------------------------------------
# Dispatch: eager vs pipeline, arrays vs scalars vs lazy handles
# ---------------------------------------------------------------------------


def dispatch(
    op_name: str,
    operands: Sequence[Any],  # ArrowArrayBase | LazyArray | AV (scalar)
    params: Optional[dict] = None,
    pipeline=None,
):
    """Common entry: route to eager execution or pipeline recording.

    Returns concrete array(s) eagerly, or LazyArray handle(s) when `pipeline`
    is given (≙ the reference's `foo` vs `foo_op` duality).
    """
    from ..runtime.pipeline import ComputePipeline, LazyArray

    if pipeline is not None:
        assert isinstance(pipeline, ComputePipeline)
        return pipeline.record(op_name, operands, params or {})

    avs = []
    for o in operands:
        if isinstance(o, AV):
            avs.append(o)
        elif isinstance(o, LazyArray):
            avs.append(array_av(o.bound()))
        elif isinstance(o, ArrowArrayBase):
            avs.append(array_av(o))
        else:
            raise TypeError(f"bad operand {type(o)}")
    outs = execute(op_name, avs, params)
    wrapped = [make_array(o.data, o.validity, o.length, o.dtype) for o in outs]
    return wrapped[0] if len(wrapped) == 1 else wrapped


# ---------------------------------------------------------------------------
# Shared validity helpers used by kernels
# ---------------------------------------------------------------------------


def merged_validity(*avs: AV) -> Optional[jnp.ndarray]:
    """AND of all present validity buffers (scalar AVs contribute none).

    ≙ ``merge_null_bit_buffer_op`` (`null_bit_buffer.rs:206-243`) for array-array
    ops and ``clone_null_bit_buffer_pass`` for scalar ops — unified, fused.
    """
    out = None
    for a in avs:
        if a.validity is not None:
            out = a.validity if out is None else (out & a.validity)
    return out


def scalar_data(b: AV) -> jnp.ndarray:
    """0-d rhs for a scalar op: a true scalar AV, or element 0 of a 1-row array
    (≙ ``apply_scalar_function`` binding a 1-element buffer,
    `gpu_device.rs:313-361`)."""
    return b.data if b.is_scalar else b.data[0]
