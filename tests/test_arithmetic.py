"""Arithmetic kernel tests, mirroring `crates/arithmetic/src/`
inline tests (f32.rs, u32.rs, i32.rs, u16.rs): wrapping semantics, null
propagation, scalar vs array forms, sum reduction."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K

from helpers import assert_values_eq, check_array_op, check_scalar_op


def test_add_scalar_f32():
    a = at.Float32Array.from_slice([0.0, 1.0, 2.0, 3.0])
    check_scalar_op(K.add_scalar, K.add_scalar_dyn, a, 100.0, [100.0, 101.0, 102.0, 103.0], 0.01)


def test_add_scalar_nullable_clones_validity():
    a = at.Float32Array.from_optional_slice([1.0, None, 3.0])
    check_scalar_op(K.add_scalar, K.add_scalar_dyn, a, 1.0, [2.0, None, 4.0], 0.01)


def test_add_array_validity_and():
    a = at.Float32Array.from_optional_slice([1.0, None, 3.0, 4.0])
    b = at.Float32Array.from_optional_slice([10.0, 20.0, None, 40.0])
    check_array_op(K.add, K.add_array_dyn, a, b, [11.0, None, None, 44.0], 0.01)


def test_sub_mul_div_rem_f32():
    a = at.Float32Array.from_slice([10.0, 9.0, -7.5, 1.0])
    b = at.Float32Array.from_slice([4.0, 3.0, 2.5, 0.0])
    check_array_op(K.sub, K.sub_array_dyn, a, b, [6.0, 6.0, -10.0, 1.0], 0.01)
    check_array_op(K.mul, K.mul_array_dyn, a, b, [40.0, 27.0, -18.75, 0.0], 0.01)
    check_array_op(K.div, K.div_array_dyn, a, b, [2.5, 3.0, -3.0, float("inf")], 0.01)
    # WGSL % is trunc-style fmod
    check_array_op(K.rem, K.rem_array_dyn, a, b, [2.0, 0.0, -0.0, float("nan")], 0.01)


def test_u32_wrapping():
    m = 2**32
    a = at.UInt32Array.from_slice(np.array([m - 100, m - 1, 5], np.uint32))
    check_scalar_op(K.add_scalar, K.add_scalar_dyn, a, 200, [100, 199, 205])
    b = at.UInt32Array.from_slice(np.array([200, 2, 10], np.uint32))
    check_array_op(K.sub, K.sub_array_dyn, b, a, [300, 3, (10 - 5) % m])
    check_array_op(
        K.mul, K.mul_array_dyn, a, b, [(m - 100) * 200 % m, (m - 1) * 2 % m, 50]
    )


def test_i32_wrapping_and_div_by_zero():
    a = at.Int32Array.from_slice([2**31 - 1, -(2**31), 7, -(2**31)])
    b = at.Int32Array.from_slice([1, -1, 0, 0])
    # add wraps
    check_array_op(K.add, K.add_array_dyn, a, b, [-(2**31), 2**31 - 1, 7, -(2**31)])
    # WGSL: x/0 == x, INT_MIN / -1 == INT_MIN
    check_array_op(K.div, K.div_array_dyn, a, b, [2**31 - 1, -(2**31), 7, -(2**31)])
    # WGSL: x%0 == 0, INT_MIN % -1 == 0
    check_array_op(K.rem, K.rem_array_dyn, a, b, [0, 0, 0, 0])


def test_rem_trunc_sign():
    a = at.Int32Array.from_slice([7, -7, 7, -7])
    b = at.Int32Array.from_slice([3, 3, -3, -3])
    check_array_op(K.rem, K.rem_array_dyn, a, b, [1, -1, 1, -1])


def test_neg():
    a = at.Float32Array.from_optional_slice([1.5, None, -2.0])
    r = K.neg(a)
    assert_values_eq(r.values(), [-1.5, None, 2.0], 0.01)
    r2 = K.neg_dyn(a)
    assert_values_eq(r2.values(), [-1.5, None, 2.0], 0.01)
    i = at.Int32Array.from_slice([-(2**31), 5])
    assert K.neg(i).values() == [-(2**31), -5]  # wrapping neg


def test_generic_dyn_routing():
    """add_dyn routes by operand length (arithmetic_kernels.rs:101-120)."""
    a = at.Float32Array.from_slice([1.0, 2.0, 3.0])
    s = at.Float32Array.from_slice([10.0])
    assert_values_eq(K.add_dyn(a, s).values(), [11.0, 12.0, 13.0], 0.01)
    assert_values_eq(K.add_dyn(s, a).values(), [11.0, 12.0, 13.0], 0.01)
    assert_values_eq(K.add_dyn(a, a).values(), [2.0, 4.0, 6.0], 0.01)


def test_date32_reuses_i32():
    d = at.Date32Array.from_slice([100, 200])
    i = at.Int32Array.from_slice([1, 2])
    r = K.add(d, i)
    assert r.dtype is at.ArrowType.DATE32
    assert r.values() == [101, 202]


def test_sum():
    a = at.Float32Array.from_slice(np.arange(1000, dtype=np.float32))
    r = K.sum_(a)
    assert len(r) == 1
    assert abs(r.values()[0] - 499500.0) < 1.0
    u = at.UInt32Array.from_slice(np.ones(4096, np.uint32))
    assert K.sum_(u).values() == [4096]
    i = at.Int32Array.from_slice(np.full(100, -3, np.int32))
    assert K.sum_(i).values() == [-300]


def test_sum_ignores_nulls_like_reference():
    # the reference sums the raw buffer: nulls contribute their stored 0
    a = at.Float32Array.from_optional_slice([1.0, None, 3.0])
    assert K.sum_(a).values()[0] == 4.0


def test_sum_large():
    n = 4 * 1024 * 1024
    a = at.UInt32Array.from_slice(np.ones(n, np.uint32))
    assert K.sum_(a).values() == [n]


def test_unsupported_dtype_raises():
    b = at.BooleanArray.from_slice([True])
    with pytest.raises(at.OperationNotSupported):
        K.add(b, b)
    with pytest.raises(at.OperationNotSupported):
        K.neg(at.UInt32Array.from_slice(np.array([1], np.uint32)))
