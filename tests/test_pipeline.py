"""ComputePipeline tests: the `examples/simple.rs` flow, fusion of chained ops,
program caching, broadcast (≙ `examples/simple.rs:12-77`)."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K
from arrow_tpu.runtime.pipeline import _compile_graph

from helpers import assert_values_eq


def test_simple_rs_flow():
    """≙ run_compute_pipeline_ops (examples/simple.rs:45-73)."""
    lhs = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0])
    with at.ComputePipeline() as pipe:
        r1 = K.add_scalar_op(lhs, 10.0, pipe)
        r2 = K.mul_scalar_op(r1, 2.0, pipe)
    assert_values_eq(r2.values(), [22.0, 24.0, 26.0, 28.0], 0.01)
    assert_values_eq(r1.values(), [11.0, 12.0, 13.0, 14.0], 0.01)


def test_lazy_before_finish_raises():
    a = at.Float32Array.from_slice([1.0])
    pipe = at.ComputePipeline()
    r = K.add_scalar_op(a, 1.0, pipe)
    with pytest.raises(RuntimeError):
        r.values()
    pipe.finish()
    assert r.values() == [2.0]


def test_mixed_ops_graph():
    a = at.Float32Array.from_optional_slice([1.0, None, 3.0, 4.0])
    b = at.Float32Array.from_slice([10.0, 20.0, 30.0, 40.0])
    pipe = at.ComputePipeline()
    s = K.add_op(a, b, pipe)
    g = K.gt_op(s, b, pipe)  # (a+b) > b
    t = K.sum_op(b, pipe)
    pipe.finish()
    assert g.values() == [True, None, True, True]
    assert t.values() == [100.0]


def test_dropped_intermediates_are_fused():
    a = at.Float32Array.from_slice([1.0, 2.0])
    pipe = at.ComputePipeline()
    r = K.mul_scalar_op(K.add_scalar_op(a, 1.0, pipe), 3.0, pipe)
    import gc

    gc.collect()
    pipe.finish()
    assert_values_eq(r.values(), [6.0, 9.0], 0.01)


def test_pipeline_cache_hit():
    a = at.Float32Array.from_slice([5.0, 6.0])
    before = _compile_graph.cache_info().currsize

    def run():
        pipe = at.ComputePipeline()
        r = K.add_scalar_op(a, 2.0, pipe)
        pipe.finish()
        return r

    r1, r2 = run(), run()
    after = _compile_graph.cache_info()
    assert after.currsize <= before + 1  # second run reuses the compiled graph
    assert r1.values() == r2.values() == [7.0, 8.0]


def test_broadcast():
    r = K.broadcast(3.5, 1000, at.ArrowType.FLOAT32)
    assert len(r) == 1000
    assert r.values()[:3] == [3.5, 3.5, 3.5]
    b = K.broadcast(True, 70, at.ArrowType.BOOL)
    assert b.values() == [True] * 70
    assert K.all_(b) is True
    u = K.broadcast(7, 10, at.ArrowType.UINT16)
    assert u.values() == [7] * 10
    # pipelined broadcast feeding another op
    pipe = at.ComputePipeline()
    c = K.broadcast_op(2.0, 4, pipe, dtype=at.ArrowType.FLOAT32)
    d = K.add_op(c, c, pipe)
    pipe.finish()
    assert_values_eq(d.values(), [4.0] * 4, 0.01)


def test_put_in_pipeline_returns_handle():
    src = at.Float32Array.from_slice([9.0])
    dst = at.Float32Array.from_slice([0.0, 1.0])
    idx0 = at.UInt32Array.from_slice(np.array([0], np.uint32))
    idx1 = at.UInt32Array.from_slice(np.array([1], np.uint32))
    pipe = at.ComputePipeline()
    out = K.put_op(src, idx0, dst, idx1, pipe)
    pipe.finish()
    assert_values_eq(out.values(), [0.0, 9.0], 0.01)
