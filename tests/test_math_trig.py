"""Math + trigonometry kernel tests mirroring `crates/math/` and
`crates/trigonometry/` inline tests."""

import math

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K

from helpers import assert_values_eq, check_unary_op


def test_float_unary_suite():
    a = at.Float32Array.from_optional_slice([4.0, 1.0, None, 0.25])
    check_unary_op(K.sqrt, K.sqrt_dyn, a, [2.0, 1.0, None, 0.5], 0.01)
    check_unary_op(
        K.exp, K.exp_dyn, a, [math.exp(4), math.e, None, math.exp(0.25)], 0.5
    )
    check_unary_op(K.exp2, K.exp2_dyn, a, [16.0, 2.0, None, 2**0.25], 0.01)
    check_unary_op(K.log, K.log_dyn, a, [math.log(4), 0.0, None, math.log(0.25)], 0.01)
    check_unary_op(K.log2, K.log2_dyn, a, [2.0, 0.0, None, -2.0], 0.01)


def test_abs():
    f = at.Float32Array.from_slice([-1.5, 2.0, -0.0])
    check_unary_op(K.abs, K.abs_dyn, f, [1.5, 2.0, 0.0], 0.01)
    i = at.Int32Array.from_optional_slice([-5, None, 7])
    assert K.abs(i).values() == [5, None, 7]


def test_cbrt_sign_preserving():
    a = at.Float32Array.from_slice([8.0, -8.0, 27.0, -27.0])
    check_unary_op(K.cbrt, K.cbrt_dyn, a, [2.0, -2.0, 3.0, -3.0], 0.01)


def test_power_f32():
    a = at.Float32Array.from_slice([2.0, 9.0, 4.0])
    p = at.Float32Array.from_slice([10.0, 0.5, -1.0])
    r = K.power(a, p)
    assert_values_eq(r.values(), [1024.0, 3.0, 0.25], 0.01)


def test_power_i32_wgsl_loop_semantics():
    a = at.Int32Array.from_slice([3, 2, -2, 5, 1, -1, -1, 0, 0])
    p = at.Int32Array.from_slice([4, 31, 3, 0, -5, -4, -3, 3, -2])
    # 2^31 wraps to INT_MIN; negative exponents follow the division loop:
    # |x|>1 -> 0; x==1 -> 1; x==-1 -> ±1 by parity; x==0 -> 1 (div-by-0 = dividend)
    r = K.power(a, p)
    assert r.values() == [81, -(2**31), -8, 1, 1, 1, -1, 0, 1]


def test_trig_f32():
    a = at.Float32Array.from_optional_slice([0.0, math.pi / 2, None])
    assert_values_eq(K.sin(a).values(), [0.0, 1.0, None], 0.01)
    assert_values_eq(K.cos(a).values(), [1.0, 0.0, None], 0.01)
    b = at.Float32Array.from_slice([1.0, -1.0, 0.0])
    assert_values_eq(K.acos(b).values(), [0.0, math.pi, math.pi / 2], 0.01)
    assert_values_eq(K.sinh(b).values(), [math.sinh(1), -math.sinh(1), 0.0], 0.01)


def test_trig_int_inputs_return_f32():
    """Integer trig returns Float32 (trigonometry/src/lib.rs BUFFER_SIZE_MULTIPLIER)."""
    for cls, vals in [
        (at.UInt8Array, [0, 1, 2]),
        (at.Int8Array, [-1, 0, 1]),
        (at.UInt16Array, [0, 3, 7]),
        (at.Int16Array, [-2, 0, 2]),
    ]:
        arr = cls.from_slice(vals)
        r = K.sin(arr)
        assert r.dtype is at.ArrowType.FLOAT32, cls.__name__
        assert_values_eq(r.values(), [math.sin(v) for v in vals], 0.01)


def test_math_unsupported():
    i = at.Int32Array.from_slice([1])
    with pytest.raises(at.OperationNotSupported):
        K.sqrt(i)
    u = at.UInt32Array.from_slice(np.array([1], np.uint32))
    with pytest.raises(at.OperationNotSupported):
        K.sin(u)
