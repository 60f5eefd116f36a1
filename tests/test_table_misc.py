"""Table, profiler, device, config, and example-flow tests."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K
from arrow_tpu.table import RecordBatch


def test_record_batch_basics():
    rb = RecordBatch.from_numpy(
        {"a": np.int32([1, 2, 3]), "b": np.float32([0.5, 1.5, 2.5])}
    )
    assert rb.num_rows == 3 and rb.num_columns == 2
    assert rb.column_names == ["a", "b"]
    assert rb.schema == [("a", at.ArrowType.INT32), ("b", at.ArrowType.FLOAT32)]
    assert "a" in rb
    sel = rb.select(["b"])
    assert sel.column_names == ["b"]
    r2 = rb.with_column("c", at.Int32Array.from_slice([7, 8, 9]))
    assert r2["c"].values() == [7, 8, 9]
    r3 = rb.rename({"a": "x"})
    assert r3.column_names == ["x", "b"]
    idx = at.UInt32Array.from_slice(np.array([2, 0], np.uint32))
    taken = rb.take(idx)
    assert taken["a"].values() == [3, 1]
    d = rb.to_pydict()
    assert d["a"] == [1, 2, 3]


def test_record_batch_length_mismatch():
    with pytest.raises(at.ArrowTpuError):
        RecordBatch(
            {
                "a": at.Int32Array.from_slice([1]),
                "b": at.Int32Array.from_slice([1, 2]),
            }
        )


def test_profiler():
    from arrow_tpu.runtime import profiler

    profiler.reset()
    at.config.profile = True
    try:
        a = at.Float32Array.from_slice([1.0, 2.0])
        K.add_scalar(a, 1.0).values()
        with at.ComputePipeline() as p:
            K.mul_scalar_op(a, 2.0, p)
    finally:
        at.config.profile = False
    t = profiler.timings()
    assert any("add_scalar" in k for k in t)
    assert any("pipeline" in k for k in t)
    assert profiler.summary()
    profiler.reset()
    assert profiler.timings() == {}


def test_device_api():
    d = at.default_device()
    assert d.platform in ("cpu", "gpu")
    buf = d.put(np.float32([1, 2, 3]))
    np.testing.assert_array_equal(d.get(buf), np.float32([1, 2, 3]))
    d.synchronize()
    assert isinstance(d.memory_stats(), dict)


def test_config():
    assert at.config.shard_axis == "x"
    old = at.config.pad_unit
    at.set_config(pad_unit=4096)
    assert at.config.pad_unit == 4096
    at.set_config(pad_unit=old)
    with pytest.raises(AttributeError):
        at.set_config(bogus=1)


def test_example_flows_run():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "simple_example",
        os.path.join(os.path.dirname(__file__), "..", "examples", "simple.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.run_eager_ops()
    mod.run_compute_pipeline_ops()
    mod.run_operator_tier()


@pytest.fixture
def native_built(monkeypatch):
    """Build the C++ host runtime (`make -C csrc`) and load it afresh."""
    import os
    import subprocess

    from arrow_tpu.runtime import native

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    subprocess.run(["make", "-s", "-C", csrc], check=True, timeout=300)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", False)
    return native


def test_native_host_runtime_if_built(native_built):
    native = native_built
    assert native.have_native()
    import numpy as np

    mask = np.random.default_rng(1).random(999) < 0.3
    from arrow_tpu.utils import bits as B

    w = B.pack_bits_np(mask, 32)
    np.testing.assert_array_equal(B.unpack_bits_np(w, 999), mask)

    # popcount / AND-merge bindings (r3 advisor: dead exports — now bound)
    assert native.popcount_native(w) == int(mask.sum())
    w2 = B.pack_bits_np(~mask, 32)
    anded = native.and_words_native(w, w2)
    assert anded is not None and int(anded.sum()) == 0
    anded_self = native.and_words_native(w, w)
    np.testing.assert_array_equal(anded_self, w)


def test_io_null_count():
    from arrow_tpu import io as aio

    arr = at.Int32Array.from_optional_slice([1, None, 3, None, None, 6])
    ex = aio.to_arrow_buffers(arr)
    assert ex["null_count"] == 3
    assert aio.to_arrow_buffers(at.Int32Array.from_slice([1, 2]))["null_count"] == 0


def test_io_arrow_buffers_roundtrip(tmp_path):
    from arrow_tpu import io as aio
    from arrow_tpu.table import RecordBatch

    rb = RecordBatch(
        {
            "x": at.Int32Array.from_optional_slice([1, None, 3, 4]),
            "f": at.Float32Array.from_slice([0.5, 1.5, 2.5, 3.5]),
            "b": at.BooleanArray.from_optional_slice([True, False, None, True]),
        }
    )
    ex = aio.to_arrow_buffers(rb["x"])
    assert ex["length"] == 4 and ex["validity"] is not None
    back = aio.from_arrow_buffers(ex["data"], 4, ex["validity"], at.ArrowType.INT32)
    assert back.values() == [1, None, 3, 4]

    p = str(tmp_path / "t.npz")
    aio.save_table(p, rb)
    rb2 = aio.load_table(p)
    assert rb2["x"].values() == [1, None, 3, 4]
    assert rb2["f"].values() == [0.5, 1.5, 2.5, 3.5]
    assert rb2["b"].values() == [True, False, None, True]


def test_ops_compose_under_user_jit():
    """Arrays are pytrees; eager ops nest inside a user jax.jit."""
    import jax

    a = at.Float32Array.from_slice([1.0, 2.0, 3.0])
    b = at.Float32Array.from_slice([10.0, 20.0, 30.0])

    @jax.jit
    def f(x, y):
        return K.mul_scalar(K.add(x, y), 2.0)

    r = f(a, b)
    assert r.values() == [22.0, 44.0, 66.0]


def test_health_probe_and_deadline():
    from arrow_tpu.runtime import health

    latency = health.probe_device(timeout_s=60.0)
    assert latency >= 0.0
    ok, val = health.with_deadline(lambda: 42, timeout_s=10.0)
    assert ok and val == 42
    import time as _t

    ok, val = health.with_deadline(lambda: _t.sleep(2.0) or 7, timeout_s=0.2, default=-1)
    assert not ok and val == -1
