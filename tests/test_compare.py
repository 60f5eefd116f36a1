"""Compare kernel tests mirroring `crates/compare/src/` inline
tests — NaN/±inf matrix from `compare/src/f32.rs:18-64`, all dtypes, min/max."""

import numpy as np

import arrow_tpu as at
from arrow_tpu import kernels as K

from helpers import check_array_op

NAN = float("nan")
INF = float("inf")


def _f32_pair():
    lhs = at.Float32Array.from_optional_slice(
        [-1.0, 3.0, -1.0, None, None, NAN, INF, -INF, -INF, INF, NAN]
    )
    rhs = at.Float32Array.from_optional_slice(
        [0.0, 2.0, None, 3.0, None, NAN, INF, -INF, INF, -INF, 3.0]
    )
    return lhs, rhs


def test_gt_f32_nan_inf_matrix():
    lhs, rhs = _f32_pair()
    check_array_op(
        K.gt, K.gt_dyn, lhs, rhs,
        [False, True, None, None, None, False, False, False, False, True, False],
    )


def test_gteq_lt_lteq_eq_f32():
    lhs, rhs = _f32_pair()
    check_array_op(
        K.gteq, K.gteq_dyn, lhs, rhs,
        [False, True, None, None, None, False, True, True, False, True, False],
    )
    check_array_op(
        K.lt, K.lt_dyn, lhs, rhs,
        [True, False, None, None, None, False, False, False, True, False, False],
    )
    check_array_op(
        K.lteq, K.lteq_dyn, lhs, rhs,
        [True, False, None, None, None, False, True, True, True, False, False],
    )
    check_array_op(
        K.eq, K.eq_dyn, lhs, rhs,
        [False, False, None, None, None, False, True, True, False, False, False],
    )


def test_compare_all_int_dtypes():
    for cls, lo, hi in [
        (at.UInt8Array, 0, 255),
        (at.UInt16Array, 0, 65535),
        (at.UInt32Array, 0, 2**32 - 1),
        (at.Int8Array, -128, 127),
        (at.Int16Array, -32768, 32767),
        (at.Int32Array, -(2**31), 2**31 - 1),
        (at.Date32Array, -1000, 1000),
    ]:
        a = cls.from_slice([lo, hi, 5])
        b = cls.from_slice([hi, lo, 5])
        assert K.lt(a, b).values() == [True, False, False], cls.__name__
        assert K.eq(a, b).values() == [False, False, True], cls.__name__
        assert K.gteq(a, b).values() == [False, True, True], cls.__name__


def test_min_max_elementwise():
    a = at.Float32Array.from_optional_slice([1.0, 5.0, None])
    b = at.Float32Array.from_optional_slice([2.0, 4.0, 1.0])
    check_array_op(K.max, K.max_array_dyn, a, b, [2.0, 5.0, None], 0.01)
    check_array_op(K.min, K.min_array_dyn, a, b, [1.0, 4.0, None], 0.01)


def test_compare_scalar_extension():
    a = at.Int32Array.from_slice([1, 5, 3])
    assert K.gt_scalar(a, 2).values() == [False, True, True]
    assert K.eq_scalar(a, 3).values() == [False, False, True]


def test_compare_large():
    n = 1 << 20
    x = np.arange(n, dtype=np.int32)
    a = at.Int32Array.from_slice(x)
    b = at.Int32Array.from_slice(x[::-1].copy())
    r = K.lt(a, b)
    got = np.array(r.raw_values())
    np.testing.assert_array_equal(got, x < x[::-1])
