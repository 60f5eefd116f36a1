"""Cast kernel tests mirroring `crates/cast/src/lib.rs` inline
tests and `docs/src/kernels/cast.md` caveats."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as K

A = at.ArrowType


def test_widening_int_casts():
    a = at.Int8Array.from_slice([-1, -128, 127])
    assert K.cast(a, A.INT16).values() == [-1, -128, 127]
    assert K.cast(a, A.INT32).values() == [-1, -128, 127]
    assert K.cast(a, A.FLOAT32).values() == [-1.0, -128.0, 127.0]
    # signed -> unsigned reinterprets/wraps
    assert K.cast(a, A.UINT8).values() == [255, 128, 127]
    assert K.cast(a, A.UINT16).values() == [65535, 65408, 127]
    assert K.cast(a, A.UINT32).values() == [2**32 - 1, 2**32 - 128, 127]


def test_u8_u16_casts():
    u = at.UInt8Array.from_slice([0, 255, 7])
    assert K.cast(u, A.UINT16).values() == [0, 255, 7]
    assert K.cast(u, A.INT8).values() == [0, -1, 7]
    assert K.cast(u, A.INT16).values() == [0, 255, 7]
    assert K.cast(u, A.FLOAT32).values() == [0.0, 255.0, 7.0]
    s = at.UInt16Array.from_slice([65535, 1, 256])
    assert K.cast(s, A.INT16).values() == [-1, 1, 256]
    assert K.cast(s, A.UINT32).values() == [65535, 1, 256]


def test_i16_casts():
    a = at.Int16Array.from_slice([-1, -32768, 1000])
    assert K.cast(a, A.INT32).values() == [-1, -32768, 1000]
    assert K.cast(a, A.UINT16).values() == [65535, 32768, 1000]
    assert K.cast(a, A.UINT32).values() == [2**32 - 1, 2**32 - 32768, 1000]
    assert K.cast(a, A.FLOAT32).values() == [-1.0, -32768.0, 1000.0]


def test_f32_to_u8_caveats():
    """WGSL `u32(f) % 256`: NaN->0, negative->0, trunc, overflow mod 256
    (`cast/compute_shaders/f32/cast_u8.wgsl`, docs cast.md)."""
    a = at.Float32Array.from_slice(
        [300.5, -5.0, 7.9, 255.0, 256.0, 257.0, float("nan"), float("inf"), -float("inf"), 1e10]
    )
    got = K.cast(a, A.UINT8).values()
    # inf and 1e10 -> u32 saturates to 4294967295 -> %256 = 255; -inf -> 0
    assert got == [44, 0, 7, 255, 0, 1, 0, 255, 0, 255]


def test_bool_to_f32():
    b = at.BooleanArray.from_optional_slice([True, False, None])
    r = K.cast(b, A.FLOAT32)
    assert r.values() == [1.0, 0.0, None]


def test_bitcast_u32_f32():
    u = at.UInt32Array.from_slice(np.array([0x3F800000, 0, 0xC0000000], np.uint32))
    r = K.bitcast(u, A.FLOAT32)
    assert r.values() == [1.0, 0.0, -2.0]
    # roundtrip bit-exact
    back = K.bitcast(r, A.UINT32)
    assert back.values() == [0x3F800000, 0, 0xC0000000]


def test_cast_preserves_validity():
    a = at.Int8Array.from_optional_slice([1, None, 3])
    assert K.cast(a, A.INT32).values() == [1, None, 3]


def test_unsupported_cast_raises():
    f = at.Float32Array.from_slice([1.0])
    with pytest.raises(at.CastingNotSupported):
        K.cast(f, A.BOOL)
    with pytest.raises(at.CastingNotSupported):
        K.bitcast(f, A.UINT8)
