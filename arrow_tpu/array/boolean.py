"""Bit-packed boolean arrays.

Redesign of ``BooleanArrayGPU``
(`crates/array/src/array/boolean_gpu.rs:15-21`): values are packed
LSB-first into uint32 words, 1 bit per row (matching the Arrow layout and the
reference's choice), stored in HBM as a `jax.Array` of words.  Logical ops on
booleans operate directly on the word buffer (32 rows per lane op) — the
equivalent of the reference routing boolean and/or/xor/not through its u32 shaders
(`logical/src/boolean.rs:45-104`).

Invariant: value bits and validity bits at positions >= len are zero.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import jax
import numpy as np

from .. import dtypes as dt
from ..runtime.device import Device, default_device
from ..utils import bits as B
from .array import ArrowArrayBase, pad_words


class BooleanArray(ArrowArrayBase):
    """Packed 1-bit boolean column (+ optional packed validity)."""

    DTYPE = dt.ArrowType.BOOL

    __slots__ = ("dtype", "_data", "_validity", "_length", "device")

    def __init__(
        self,
        data: jax.Array,  # uint32 packed value words
        validity: Optional[jax.Array],
        length: int,
        device: Optional[Device] = None,
    ):
        self._data = data
        self._validity = validity
        self._length = length
        self.dtype = dt.ArrowType.BOOL
        self.device = device if device is not None else default_device()

    # -- construction (≙ boolean_gpu.rs:24-50) -------------------------------

    @classmethod
    def from_slice(
        cls, values: Sequence[bool], device: Optional[Device] = None
    ) -> "BooleanArray":
        device = device or default_device()
        mask = np.asarray(values, dtype=np.bool_)
        n = mask.shape[0]
        words = B.pack_bits_np(mask, pad_words(n))
        return cls(device.put(words), None, n, device)

    @classmethod
    def from_optional_slice(
        cls, values: Iterable[Optional[bool]], device: Optional[Device] = None
    ) -> "BooleanArray":
        device = device or default_device()
        vals = list(values)
        n = len(vals)
        data = np.fromiter((bool(v) for v in vals), count=n, dtype=np.bool_)
        valid = np.fromiter((v is not None for v in vals), count=n, dtype=np.bool_)
        words = B.pack_bits_np(data & valid, pad_words(n))
        if valid.all():
            return cls(device.put(words), None, n, device)
        vwords = B.pack_bits_np(valid, pad_words(n))
        return cls(device.put(words), device.put(vwords), n, device)

    @classmethod
    def from_words(
        cls,
        words: jax.Array,
        length: int,
        validity: Optional[jax.Array] = None,
        device: Optional[Device] = None,
    ) -> "BooleanArray":
        return cls(words, validity, length, device)

    # -- accessors ------------------------------------------------------------

    @property
    def data(self) -> jax.Array:
        """Packed uint32 value words."""
        return self._data

    @property
    def validity(self) -> Optional[jax.Array]:
        return self._validity

    @property
    def padded_length(self) -> int:
        return int(self._data.shape[0]) * B.WORD_BITS

    def raw_values(self) -> np.ndarray:
        """bool[len] readback ignoring validity (≙ boolean_gpu.rs:84-91)."""
        return B.unpack_bits_np(np.asarray(self._data), self._length)

    def values(self) -> list:
        raw = self.raw_values().tolist()
        if self._validity is None:
            return raw
        mask = B.unpack_bits_np(np.asarray(self._validity), self._length)
        return [v if m else None for v, m in zip(raw, mask)]

    def to_numpy(self) -> np.ndarray:
        return self.raw_values()

    def clone(self) -> "BooleanArray":
        return BooleanArray(self._data, self._validity, self._length, self.device)

    def __repr__(self) -> str:
        head = self.values()[:10]
        suffix = ", ..." if self._length > 10 else ""
        return f"BooleanArray(len={self._length}, values={head}{suffix})"


def _flatten(a: BooleanArray):
    return (a._data, a._validity), (a._length, a.device)


def _unflatten(aux, children):
    length, device = aux
    data, validity = children
    return BooleanArray(data, validity, length, device)


jax.tree_util.register_pytree_node(BooleanArray, _flatten, _unflatten)
