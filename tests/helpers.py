"""Assertion helpers (≙ the reference's test-macro crate
`crates/test_macros/src/lib.rs`): each helper checks BOTH the
typed path and the `_dyn` path (`lib.rs:33-51`), with NaN/±inf-aware float
comparison at 0.01 tolerance (`lib.rs:88-117`)."""

from __future__ import annotations

import math

import numpy as np

import arrow_tpu as at
from arrow_tpu import kernels as K


def float_eq_in_error(a, b, tol=0.01) -> bool:
    """≙ `test_macros/src/lib.rs:88-117`."""
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) and math.isnan(b):
        return True
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= tol


def assert_values_eq(got, expected, float_tol=None):
    assert len(got) == len(expected), f"len {len(got)} != {len(expected)}"
    for i, (g, e) in enumerate(zip(got, expected)):
        if float_tol is not None:
            ok = float_eq_in_error(g, e, float_tol)
        else:
            ok = g == e or (g is None and e is None)
        assert ok, f"row {i}: got {g!r}, expected {e!r}\nall got: {got}\nexp: {expected}"


def check_array_op(op, dyn_op, lhs, rhs, expected, float_tol=None):
    """Binary array op, typed + dyn + pipelined (`test_array_op!` lib.rs:119-170)."""
    r = op(lhs, rhs)
    assert_values_eq(r.values(), expected, float_tol)
    r2 = dyn_op(lhs, rhs)
    assert_values_eq(r2.values(), expected, float_tol)
    # pipelined flavor must agree with eager
    p = at.ComputePipeline()
    r3 = op(lhs, rhs, p)
    p.finish()
    assert_values_eq(r3.values(), expected, float_tol)


def check_scalar_op(op, dyn_op, lhs, scalar, expected, float_tol=None):
    r = op(lhs, scalar)
    assert_values_eq(r.values(), expected, float_tol)
    r2 = dyn_op(lhs, scalar)
    assert_values_eq(r2.values(), expected, float_tol)
    p = at.ComputePipeline()
    r3 = op(lhs, scalar, p)
    p.finish()
    assert_values_eq(r3.values(), expected, float_tol)


def check_unary_op(op, dyn_op, arr, expected, float_tol=None):
    r = op(arr)
    assert_values_eq(r.values(), expected, float_tol)
    r2 = dyn_op(arr)
    assert_values_eq(r2.values(), expected, float_tol)
    p = at.ComputePipeline()
    r3 = op(arr, p)
    p.finish()
    assert_values_eq(r3.values(), expected, float_tol)
