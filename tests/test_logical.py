"""Logical kernel tests mirroring `crates/logical/src/` inline
tests: bitwise ops on ints and packed booleans, shifts, any/all."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K

from helpers import check_array_op


def test_bitwise_int():
    a = at.UInt32Array.from_slice(np.array([0b1100, 0xFFFFFFFF, 0], np.uint32))
    b = at.UInt32Array.from_slice(np.array([0b1010, 0, 7], np.uint32))
    check_array_op(K.bitwise_and, K.bitwise_and_dyn, a, b, [0b1000, 0, 0])
    check_array_op(K.bitwise_or, K.bitwise_or_dyn, a, b, [0b1110, 0xFFFFFFFF, 7])
    check_array_op(K.bitwise_xor, K.bitwise_xor_dyn, a, b, [0b0110, 0xFFFFFFFF, 7])


def test_bitwise_not_int():
    a = at.Int32Array.from_optional_slice([0, -1, None])
    r = K.bitwise_not(a)
    assert r.values() == [-1, 0, None]
    u = at.UInt8Array.from_slice([0, 255, 1])
    assert K.bitwise_not(u).values() == [255, 0, 254]


def test_boolean_logic_packed():
    a = at.BooleanArray.from_optional_slice([True, True, False, None])
    b = at.BooleanArray.from_optional_slice([True, False, False, True])
    assert K.bitwise_and(a, b).values() == [True, False, False, None]
    assert K.bitwise_or(a, b).values() == [True, True, False, None]
    assert K.bitwise_xor(a, b).values() == [False, True, False, None]
    assert K.bitwise_not(a).values() == [False, False, True, None]


def test_not_tail_invariant():
    b = at.BooleanArray.from_slice([False] * 5)
    r = K.bitwise_not(b)
    assert r.values() == [True] * 5
    # tail bits beyond len must stay zero so any/all work
    assert K.all_(r) is True
    assert K.any_(b) is False


def test_shifts_32bit():
    a = at.UInt32Array.from_slice(np.array([1, 0x80000000, 0xF0], np.uint32))
    s = at.UInt32Array.from_slice(np.array([4, 1, 32], np.uint32))
    # WGSL masks shift amount to &31: shift by 32 == shift by 0
    assert K.bitwise_shl(a, s).values() == [16, 0, 0xF0]
    assert K.bitwise_shr(a, s).values() == [0, 0x40000000, 0xF0]
    i = at.Int32Array.from_slice([-16, -1, 8])
    si = at.UInt32Array.from_slice(np.array([2, 1, 1], np.uint32))
    assert K.bitwise_shr(i, si).values() == [-4, -1, 4]  # arithmetic shift


def test_shifts_subword():
    # u8: widen to u32, shift, truncate back (logical/compute_shaders/u8/shift.wgsl)
    a = at.UInt8Array.from_slice([0x80, 1, 0xFF])
    s = at.UInt32Array.from_slice(np.array([1, 9, 4], np.uint32))
    assert K.bitwise_shl(a, s).values() == [0, (1 << 9) & 0xFF, 0xF0]  # 512 & 0xFF == 0
    i8 = at.Int8Array.from_slice([-128, -2, 64])
    si = at.UInt32Array.from_slice(np.array([1, 1, 1], np.uint32))
    # i8 widened to i32: -128>>1 = -64; trunc back
    assert K.bitwise_shr(i8, si).values() == [-64, -1, 32]


def test_any_all():
    assert K.any_(at.BooleanArray.from_slice([False, False, True])) is True
    assert K.any_(at.BooleanArray.from_slice([False] * 100)) is False
    assert K.all_(at.BooleanArray.from_slice([True] * 100)) is True
    assert K.all_(at.BooleanArray.from_slice([True] * 99 + [False])) is False


def test_any_all_large():
    n = 2_000_000
    v = np.zeros(n, dtype=bool)
    assert K.any_(at.BooleanArray.from_slice(v)) is False
    v[n - 1] = True
    assert K.any_(at.BooleanArray.from_slice(v)) is True
    assert K.all_(at.BooleanArray.from_slice(np.ones(n, bool))) is True


def test_shift_requires_u32_amounts():
    a = at.UInt32Array.from_slice(np.array([1], np.uint32))
    bad = at.Int32Array.from_slice([1])
    with pytest.raises(at.OperationNotSupported):
        K.bitwise_shl(a, bad)
