"""Typed columnar arrays resident in device memory.

Redesign of the reference's array layer
(`crates/array/src/array/primitive_array_gpu.rs`):

- ``PrimitiveArrayGpu<T>`` (`primitive_array_gpu.rs:12-19`) — {wgpu data buffer,
  device, len, optional null bitmap} — becomes :class:`PrimitiveArray`: a padded
  dense `jax.Array` value buffer + optional packed-uint32 validity buffer + logical
  length.  Buffers are padded to a multiple of `config.pad_unit` elements
  instead of the reference's 4-byte alignment (`primitive_array_gpu.rs:28`), so
  one compiled program serves every length that rounds to the same size.
- ``from_optional_slice`` (`primitive_array_gpu.rs:22-55`): None -> default value in
  the data buffer + a cleared validity bit, exactly as the reference.
- ``values``/``raw_values`` readback (`primitive_array_gpu.rs:76-104`) become
  blocking `np.asarray` readbacks sliced to the logical length.
- the per-dtype aliases (`f32_gpu.rs:11` etc.) become thin subclasses with a fixed
  ``DTYPE``.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..config import config
from ..runtime.device import Device, default_device
from ..utils import bits as B
from .validity import NullBitBuffer


def pad_len(n: int) -> int:
    """Round a logical length up to a multiple of `config.pad_unit`."""
    u = config.pad_unit
    return ((n + u - 1) // u) * u if n else 0


def pad_words(n: int) -> int:
    """Number of uint32 bitmap words for a padded length."""
    return pad_len(n) // B.WORD_BITS if n else 0


class ArrowArrayBase:
    """Common API of every array (≙ the accessor surface of the reference's
    ``ArrowArrayGPU`` enum, `array/mod.rs:104-186`)."""

    dtype: dt.ArrowType
    _length: int
    device: Device

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    @property
    def data_type(self) -> dt.DataType:
        return dt.DataType(self.dtype)

    def null_count(self) -> int:
        v = self.validity
        return 0 if v is None else self._length - int(B.popcount_words(v))

    def is_valid(self, i: int) -> bool:
        if not 0 <= i < self._length:
            raise IndexError(i)
        v = self.validity
        if v is None:
            return True
        w = int(np.asarray(v[i // B.WORD_BITS]))
        return bool((w >> (i % B.WORD_BITS)) & 1)

    def is_null(self, i: int) -> bool:
        return not self.is_valid(i)

    def null_buffer(self) -> Optional[NullBitBuffer]:
        v = self.validity
        return None if v is None else NullBitBuffer(v, self._length)

    def null_mask(self) -> Optional[np.ndarray]:
        """Host bool mask (True = valid), or None if no nulls tracked."""
        v = self.validity
        if v is None:
            return None
        return B.unpack_bits_np(np.asarray(v), self._length)

    # subclasses provide: validity (property), clone(), values(), raw_values()


class PrimitiveArray(ArrowArrayBase):
    """Dense fixed-width column: padded data buffer + optional validity bitmap."""

    DTYPE: Optional[dt.ArrowType] = None  # fixed in per-dtype subclasses

    __slots__ = ("dtype", "_data", "_validity", "_length", "device")

    def __init__(
        self,
        data: jax.Array,
        validity: Optional[jax.Array],
        length: int,
        dtype: dt.ArrowType,
        device: Optional[Device] = None,
    ):
        self._data = data
        self._validity = validity
        self._length = length
        self.dtype = dtype
        self.device = device if device is not None else default_device()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_slice(
        cls,
        values: Union[Sequence[Any], np.ndarray],
        dtype: Optional[dt.ArrowType] = None,
        device: Optional[Device] = None,
    ) -> "PrimitiveArray":
        dtype = dtype or cls.DTYPE
        if dtype is None:
            dtype = dt.from_numpy_dtype(np.asarray(values).dtype)
        device = device or default_device()
        host = np.asarray(values, dtype=dt.info(dtype).numpy)
        n = host.shape[0]
        buf = np.zeros(pad_len(n), dtype=host.dtype)
        buf[:n] = host
        return make_array(device.put(buf), None, n, dtype, device)

    @classmethod
    def from_optional_slice(
        cls,
        values: Iterable[Optional[Any]],
        dtype: Optional[dt.ArrowType] = None,
        device: Optional[Device] = None,
    ) -> "PrimitiveArray":
        """None -> default(0) data value + cleared validity bit
        (≙ `primitive_array_gpu.rs:22-55`)."""
        dtype = dtype or cls.DTYPE
        device = device or default_device()
        from ..runtime import native

        vals, mask, n = native.densify_optionals(
            values, dt.info(dtype).numpy if dtype else None
        )
        if dtype is None:
            dtype = dt.from_numpy_dtype(vals.dtype)
        buf = np.zeros(pad_len(n), dtype=dt.info(dtype).numpy)
        buf[:n] = vals
        if mask is None or mask.all():
            return make_array(device.put(buf), None, n, dtype, device)
        words = B.pack_bits_np(mask, pad_words(n))
        return make_array(device.put(buf), device.put(words), n, dtype, device)

    @classmethod
    def from_jax(
        cls,
        data: jax.Array,
        length: Optional[int] = None,
        validity: Optional[jax.Array] = None,
        dtype: Optional[dt.ArrowType] = None,
        device: Optional[Device] = None,
    ) -> "PrimitiveArray":
        """Wrap an existing (already padded or exact-length) device buffer."""
        n = int(data.shape[0]) if length is None else length
        dtype = dtype or cls.DTYPE or dt.from_numpy_dtype(np.dtype(data.dtype))
        if data.shape[0] < pad_len(n):
            data = jnp.pad(data, (0, pad_len(n) - data.shape[0]))
        return make_array(data, validity, n, dtype, device or default_device())

    # -- accessors ------------------------------------------------------------

    @property
    def data(self) -> jax.Array:
        """The padded device value buffer."""
        return self._data

    @property
    def validity(self) -> Optional[jax.Array]:
        return self._validity

    @property
    def padded_length(self) -> int:
        return int(self._data.shape[0])

    def raw_values(self) -> np.ndarray:
        """Readback of the dense value buffer (nulls hold default values);
        ≙ `primitive_array_gpu.rs:57-74`."""
        return np.asarray(self._data)[: self._length]

    def values(self) -> list:
        """Readback as list of Optional scalars (≙ `primitive_array_gpu.rs:76-104`)."""
        raw = self.raw_values()
        py = raw.tolist()
        if self._validity is None:
            return py
        mask = B.unpack_bits_np(np.asarray(self._validity), self._length)
        return [v if m else None for v, m in zip(py, mask)]

    def to_numpy(self) -> np.ndarray:
        return self.raw_values()

    def clone(self) -> "PrimitiveArray":
        """≙ clone via buffer copy (`gpu_device.rs:212-230`); jax.Arrays are
        immutable so this is a metadata copy."""
        return make_array(self._data, self._validity, self._length, self.dtype, self.device)

    def __repr__(self) -> str:
        head = self.values()[:10]
        suffix = ", ..." if self._length > 10 else ""
        return (
            f"{type(self).__name__}(len={self._length}, dtype={self.dtype.value}, "
            f"values={head}{suffix})"
        )


# -- per-dtype aliases (≙ `f32_gpu.rs:11` type aliases) -----------------------


class Float32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.FLOAT32


class Float64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.FLOAT64


class UInt8Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT8


class UInt16Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT16


class UInt32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT32


class UInt64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT64


class Int8Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT8


class Int16Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT16


class Int32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT32


class Int64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT64


class Date32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.DATE32


_CLASS_BY_DTYPE: dict[dt.ArrowType, type] = {
    dt.ArrowType.FLOAT32: Float32Array,
    dt.ArrowType.FLOAT64: Float64Array,
    dt.ArrowType.UINT8: UInt8Array,
    dt.ArrowType.UINT16: UInt16Array,
    dt.ArrowType.UINT32: UInt32Array,
    dt.ArrowType.UINT64: UInt64Array,
    dt.ArrowType.INT8: Int8Array,
    dt.ArrowType.INT16: Int16Array,
    dt.ArrowType.INT32: Int32Array,
    dt.ArrowType.INT64: Int64Array,
    dt.ArrowType.DATE32: Date32Array,
}


def make_array(
    data: jax.Array,
    validity: Optional[jax.Array],
    length: int,
    dtype: dt.ArrowType,
    device: Optional[Device] = None,
) -> ArrowArrayBase:
    """Factory returning the specific subclass for `dtype` (incl. BooleanArray)."""
    if dtype is dt.ArrowType.BOOL:
        from .boolean import BooleanArray

        return BooleanArray(data, validity, length, device)
    cls = _CLASS_BY_DTYPE[dtype]
    arr = cls.__new__(cls)
    PrimitiveArray.__init__(arr, data, validity, length, dtype, device)
    return arr


# -- pytree registration so arrays can cross jit/shard_map boundaries --------


def _flatten(a: PrimitiveArray):
    return (a._data, a._validity), (a.dtype, a._length, a.device)


def _unflatten(aux, children):
    dtype, length, device = aux
    data, validity = children
    return make_array(data, validity, length, dtype, device)


for _cls in [PrimitiveArray, *_CLASS_BY_DTYPE.values()]:
    jax.tree_util.register_pytree_node(_cls, _flatten, _unflatten)
