"""Validity (null) bitmaps.

Redesign of the reference's null layer
(`crates/array/src/array/null_bit_buffer.rs`):

- ``BooleanBufferBuilder`` (`null_bit_buffer.rs:10-62`) — CPU-side LSB-first bit
  builder — becomes :class:`BitBufferBuilder` (numpy-backed, vectorized, with an
  optional C++ fast path via `arrow_tpu.runtime.native`).
- ``NullBitBufferGpu`` (`null_bit_buffer.rs:92-96`) becomes :class:`NullBitBuffer`:
  packed uint32 words living in HBM as a `jax.Array`.
- ``merge_null_bit_buffer`` (`null_bit_buffer.rs:168-204`), which launches a WGSL
  ``bitwise_and`` shader, becomes a traced `&` that XLA fuses into the consuming
  op's program — the reference's two compute passes per nullable binary op
  (SURVEY.md §3.3) collapse into one fused HLO here.

Invariant: bits at positions >= len are zero.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import bits as B


class BitBufferBuilder:
    """Host-side LSB-first bit builder (≙ ``BooleanBufferBuilder``)."""

    def __init__(self, length: int = 0):
        self._mask = np.zeros(length, dtype=np.bool_)

    @classmethod
    def from_bools(cls, values) -> "BitBufferBuilder":
        b = cls(0)
        b._mask = np.asarray(values, dtype=np.bool_)
        return b

    def __len__(self) -> int:
        return int(self._mask.shape[0])

    def append(self, value: bool) -> None:
        self._mask = np.append(self._mask, np.bool_(value))

    def set_bit(self, i: int) -> None:
        self._mask[i] = True

    def unset_bit(self, i: int) -> None:
        self._mask[i] = False

    def is_set(self, i: int) -> bool:
        return bool(self._mask[i])

    def words(self, pad_words: Optional[int] = None) -> np.ndarray:
        return B.pack_bits_np(self._mask, pad_words)

    def mask(self) -> np.ndarray:
        return self._mask


class NullBitBuffer:
    """Device-resident packed validity bitmap (1 = valid, LSB-first uint32)."""

    __slots__ = ("words", "length")

    def __init__(self, words: jax.Array, length: int):
        self.words = words  # uint32[num_words(padded bits)]
        self.length = length

    # -- construction --------------------------------------------------------

    @classmethod
    def from_mask_np(
        cls, mask: np.ndarray, length: int, pad_words: int, device=None
    ) -> "NullBitBuffer":
        w = B.pack_bits_np(mask[:length], pad_words)
        arr = jax.device_put(w, device.jax_device if device is not None else None)
        return cls(arr, length)

    @classmethod
    def from_words(cls, words: jax.Array, length: int) -> "NullBitBuffer":
        return cls(words, length)

    @classmethod
    def all_valid_words(cls, length: int, n_words: int) -> jnp.ndarray:
        return B.tail_mask_words(n_words, length)

    # -- ops -----------------------------------------------------------------

    def clone(self) -> "NullBitBuffer":
        return NullBitBuffer(self.words, self.length)

    def to_mask_np(self) -> np.ndarray:
        return B.unpack_bits_np(np.asarray(self.words), self.length)

    def null_count(self) -> int:
        return self.length - int(B.popcount_words(self.words))

    def is_valid(self, i: int) -> bool:
        if not 0 <= i < self.length:
            raise IndexError(i)
        w = int(np.asarray(self.words[i // 32]))
        return bool((w >> (i % 32)) & 1)


def merge_validity(
    a: Optional[jnp.ndarray], b: Optional[jnp.ndarray]
) -> Optional[jnp.ndarray]:
    """AND-combine two optional packed validity word buffers (traced).

    ≙ `null_bit_buffer.rs:206-243` (merge as a ``bitwise_and`` GPU pass); here the
    `&` fuses into the consuming XLA program.
    """
    if a is None:
        return b
    if b is None:
        return a
    return a & b
