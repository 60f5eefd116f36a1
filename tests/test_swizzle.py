"""Swizzle tests mirroring `crates/routines/src/` inline tests,
including the 4-way merge validity vectors from `routines/src/bool.rs:136-187`."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K

from helpers import assert_values_eq


def u32(vals):
    return at.UInt32Array.from_slice(np.asarray(vals, np.uint32))


def test_merge_f32():
    a = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0])
    b = at.Float32Array.from_slice([10.0, 20.0, 30.0, 40.0])
    m = at.BooleanArray.from_slice([True, False, True, False])
    r = K.merge(a, b, m)
    assert_values_eq(r.values(), [1.0, 20.0, 3.0, 40.0], 0.01)
    r2 = K.merge_dyn(a, b, m)
    assert_values_eq(r2.values(), [1.0, 20.0, 3.0, 40.0], 0.01)


def test_merge_bool_reference_vectors():
    """Exact vectors from routines/src/bool.rs test_merge_bool_array_bool."""
    op1 = at.BooleanArray.from_optional_slice(
        [True, True, None, None, True, True, True, None, True]
    )
    op2 = at.BooleanArray.from_optional_slice(
        [False, False, None, False, None, None, False, False, None]
    )
    mask = at.BooleanArray.from_optional_slice(
        [True, True, False, False, True, False, None, None, False]
    )
    r = K.merge(op1, op2, mask)
    assert r.values() == [True, True, None, False, True, None, None, None, None]


def test_merge_asymmetric_validity_quirk():
    """If only one side tracks validity, rows from the other side go null
    (merge.rs:66-68 `(None, Some(mb)) | (Some(mb), None) => Some(mb)`)."""
    a = at.Float32Array.from_slice([1.0, 2.0])  # no validity buffer
    b = at.Float32Array.from_optional_slice([10.0, None])
    m = at.BooleanArray.from_slice([True, False])
    r = K.merge(a, b, m)
    # v = vb & ~m = [0, 0] -> both null (reference parity)
    assert r.values() == [None, None]


def test_take():
    a = at.Float32Array.from_optional_slice([10.0, None, 30.0])
    idx = u32([2, 0, 1, 2, 0])
    r = K.take(a, idx)
    assert len(r) == 5
    assert_values_eq(r.values(), [30.0, 10.0, None, 30.0, 10.0], 0.01)
    r2 = K.take_dyn(a, idx)
    assert_values_eq(r2.values(), [30.0, 10.0, None, 30.0, 10.0], 0.01)


def test_take_bool_bits():
    a = at.BooleanArray.from_slice([True, False, True, False, True])
    idx = u32([4, 3, 0, 0])
    assert K.take(a, idx).values() == [True, False, True, True]


def test_take_all_dtypes():
    idx = u32([1, 0])
    for cls, vals in [
        (at.Int32Array, [1, 2]),
        (at.UInt32Array, [1, 2]),
        (at.Date32Array, [1, 2]),
        (at.UInt8Array, [1, 2]),
        (at.Int16Array, [1, 2]),
    ]:
        assert K.take(cls.from_slice(vals), idx).values() == [2, 1], cls.__name__


def test_put_mutates_dst():
    src = at.Float32Array.from_slice([100.0, 200.0])
    dst = at.Float32Array.from_slice([0.0, 1.0, 2.0, 3.0])
    K.put(src, u32([0, 1]), dst, u32([3, 1]))
    assert_values_eq(dst.values(), [0.0, 200.0, 2.0, 100.0], 0.01)


def test_put_bool():
    src = at.BooleanArray.from_slice([True, True])
    dst = at.BooleanArray.from_slice([False, False, False, False])
    K.put(src, u32([0, 1]), dst, u32([0, 2]))
    assert dst.values() == [True, False, True, False]


def test_put_null_propagation_extension():
    """The reference leaves this todo!() (routines/src/lib.rs:164-169); we
    propagate src validity into dst."""
    src = at.Float32Array.from_optional_slice([100.0, None])
    dst = at.Float32Array.from_slice([0.0, 1.0, 2.0])
    K.put(src, u32([0, 1]), dst, u32([2, 0]))
    assert_values_eq(dst.values(), [None, 1.0, 100.0], 0.01)


def test_take_requires_u32_indexes():
    a = at.Float32Array.from_slice([1.0])
    with pytest.raises(at.OperationNotSupported):
        K.take(a, at.Int32Array.from_slice([0]))
