"""Opaque device buffer handle.

≙ the reference's ``ArrowGpuBuffer`` (`crates/array/src/array/buffer.rs:5-25`),
a refcounted ``Arc<wgpu::Buffer>``.  `jax.Array` is already an immutable refcounted
device buffer, so this wrapper only adds the Arrow Buffer API surface.
"""

from __future__ import annotations

import jax
import numpy as np


class Buffer:
    """Refcounted immutable device buffer."""

    __slots__ = ("_arr",)

    def __init__(self, arr: jax.Array):
        self._arr = arr

    @property
    def jax_array(self) -> jax.Array:
        return self._arr

    def __len__(self) -> int:
        return self.size

    @property
    def size(self) -> int:
        """Size in bytes."""
        return int(self._arr.size) * self._arr.dtype.itemsize

    @property
    def capacity(self) -> int:
        return self.size

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._arr)

    def as_slice(self) -> bytes:
        return self.to_numpy().tobytes()

    def ptr_eq(self, other: "Buffer") -> bool:
        return self._arr is other._arr

    def __repr__(self) -> str:
        return f"Buffer(bytes={self.size}, dtype={self._arr.dtype})"
