"""Array layer tests: construction, readback, nulls, clone, bitmap utilities.

Mirrors the inline tests of `crates/array/src/array/`
(primitive_array_gpu.rs, boolean_gpu.rs, null_bit_buffer.rs).
"""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.array.array import pad_len
from arrow_tpu.utils import bits as B


def test_from_slice_roundtrip():
    a = at.Float32Array.from_slice([1.5, -2.0, 3.25])
    assert len(a) == 3
    assert a.values() == [1.5, -2.0, 3.25]
    assert a.null_count() == 0
    assert a.null_mask() is None
    np.testing.assert_array_equal(a.raw_values(), np.float32([1.5, -2.0, 3.25]))


def test_from_optional_slice_nulls():
    a = at.Int32Array.from_optional_slice([1, None, 3, None])
    assert a.values() == [1, None, 3, None]
    # nulls hold the default value in the dense buffer (primitive_array_gpu.rs:33-43)
    np.testing.assert_array_equal(a.raw_values(), np.int32([1, 0, 3, 0]))
    assert a.null_count() == 2
    assert a.is_valid(0) and a.is_null(1)


def test_all_dtypes_roundtrip():
    cases = [
        (at.UInt8Array, [0, 255, 17]),
        (at.UInt16Array, [0, 65535, 1000]),
        (at.UInt32Array, [0, 2**32 - 1, 7]),
        (at.Int8Array, [-128, 127, 0]),
        (at.Int16Array, [-32768, 32767, 5]),
        (at.Int32Array, [-(2**31), 2**31 - 1, 42]),
        (at.Date32Array, [0, 19000, -365]),
        (at.Int64Array, [-(2**63), 2**63 - 1, 9]),
        (at.UInt64Array, [0, 2**64 - 1, 3]),
    ]
    for cls, vals in cases:
        arr = cls.from_slice(vals)
        assert arr.values() == vals, cls.__name__
        assert arr.dtype is cls.DTYPE


def test_boolean_array():
    vals = [True, False, True, True, False]
    b = at.BooleanArray.from_slice(vals)
    assert b.values() == vals
    ob = at.BooleanArray.from_optional_slice([True, None, False])
    assert ob.values() == [True, None, False]
    assert ob.null_count() == 1


def test_padding_and_invariants():
    n = 1500
    a = at.Float32Array.from_slice(np.arange(n, dtype=np.float32))
    assert a.padded_length == pad_len(n) == 8192  # pad_unit: Pallas kernel block
    # padding values are zero on upload
    assert np.asarray(a.data)[n:].sum() == 0


def test_validity_tail_invariant():
    a = at.Int32Array.from_optional_slice([1, None] * 40)
    words = np.asarray(a.validity)
    mask = B.unpack_bits_np(words, words.shape[0] * 32)
    assert not mask[80:].any()  # bits >= length are zero


def test_clone_and_buffer():
    a = at.Float32Array.from_optional_slice([1.0, None])
    c = a.clone()
    assert c.values() == a.values()
    buf = at.Buffer(a.data)
    assert buf.size == a.padded_length * 4
    assert buf.ptr_eq(at.Buffer(a.data))


def test_bit_buffer_builder():
    b = at.BitBufferBuilder(10)
    b.set_bit(0)
    b.set_bit(9)
    assert b.is_set(0) and b.is_set(9) and not b.is_set(5)
    b.unset_bit(0)
    assert not b.is_set(0)
    words = b.words()
    assert words[0] == 1 << 9


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    mask = rng.random(1000) < 0.5
    w = B.pack_bits_np(mask, 32)
    back = B.unpack_bits_np(w, 1000)
    np.testing.assert_array_equal(mask, back)


def test_datatype_parity():
    """≙ python_wgarrow datatype surface (`src/datatype.rs:10-199`)."""
    from arrow_tpu import dtypes as dt

    assert dt.int8().bit_width == 8
    assert dt.uint32().byte_width == 4
    # ≙ datatype.rs:40-53: primitives have zero child fields
    assert dt.uint32().num_fields == 0
    assert dt.bool_().num_fields == 0
    assert dt.is_integer_dt(dt.int16())
    assert dt.is_signed_integer(dt.int64())
    assert dt.is_unsigned_integer(dt.uint8())
    assert dt.is_floating(dt.float32())
    assert dt.is_boolean(dt.bool_())
    assert dt.is_temporal_dt(dt.date32())
    assert dt.is_primitive(dt.float64())
    assert not dt.is_primitive(dt.bool_())
    assert dt.int32() == dt.int32()
    assert dt.int32() != dt.uint32()


def test_scalar():
    s = at.Scalar.of(3.5)
    assert s.dtype is at.ArrowType.FLOAT32
    assert at.Scalar.of(3).dtype is at.ArrowType.INT32
    assert at.Scalar.of(True).dtype is at.ArrowType.BOOL
