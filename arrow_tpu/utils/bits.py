"""Packed-bitmap helpers (Arrow LSB-first layout in uint32 words).

The engine stores boolean values and validity bitmaps bit-packed: bit ``i`` of word
``w`` holds row ``w*32 + i`` (LSB-first).  On little-endian hosts the uint32 word
buffer viewed as bytes is exactly Arrow's validity-buffer byte layout, so host
round-trips are zero-cost reinterprets.

This replaces the reference's CPU-side ``BooleanBufferBuilder``
(`crates/array/src/array/null_bit_buffer.rs:10-62`) and its WGSL
atomicOr bit-packing shaders (`compare/compute_shaders/f32/cmp.wgsl:14-31`): here
pack/unpack are expressed as reshapes + integer dot/shift ops that XLA fuses into
the surrounding elementwise program — no atomics needed.

Invariant maintained everywhere: bits at positions >= logical length are ZERO.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

WORD_BITS = 32

# uint32 [32] = 1 << i ; used to pack bools via dot product.
_BIT_WEIGHTS_NP = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


def num_words(length: int) -> int:
    return (length + WORD_BITS - 1) // WORD_BITS


# ---------------------------------------------------------------------------
# device-side (jnp, traceable)
# ---------------------------------------------------------------------------


def pack_bits(mask: jnp.ndarray) -> jnp.ndarray:
    """bool[N*32] -> uint32[N] (LSB-first). N*32 must be the padded length."""
    m = mask.reshape(-1, WORD_BITS).astype(jnp.uint32)
    return (m << jnp.arange(WORD_BITS, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32
    )


def unpack_bits(words: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """uint32[W] -> bool[W*32] (or first n)."""
    bits = (
        words[:, None] >> jnp.arange(WORD_BITS, dtype=jnp.uint32)[None, :]
    ) & jnp.uint32(1)
    flat = bits.reshape(-1).astype(jnp.bool_)
    return flat if n is None else flat[:n]


def tail_mask_words(n_words: int, length: int) -> jnp.ndarray:
    """uint32[n_words]: all-ones below `length` bits, zeros above."""
    full = length // WORD_BITS
    rem = length % WORD_BITS
    idx = jnp.arange(n_words, dtype=jnp.uint32)
    ones = jnp.uint32(0xFFFFFFFF)
    partial = jnp.uint32((1 << rem) - 1) if rem else jnp.uint32(0)
    return jnp.where(idx < full, ones, jnp.where(idx == full, partial, jnp.uint32(0)))


def mask_tail(words: jnp.ndarray, length: int) -> jnp.ndarray:
    """Zero all bits at positions >= length."""
    return words & tail_mask_words(words.shape[0], length)


def popcount_words(words: jnp.ndarray) -> jnp.ndarray:
    """Total number of set bits (uint32 scalar)."""
    return jnp.sum(jax_popcount(words), dtype=jnp.uint32)


def jax_popcount(words: jnp.ndarray) -> jnp.ndarray:
    """Per-word popcount; lowers to the VPU popcnt via lax.population_count."""
    import jax.lax as lax

    return lax.population_count(words)


# ---------------------------------------------------------------------------
# host-side (numpy)
# ---------------------------------------------------------------------------


def pack_bits_np(mask: np.ndarray, pad_words: int | None = None) -> np.ndarray:
    """bool[N] -> uint32[ceil(N/32)] (LSB-first), optionally padded with 0-words.

    Prefers the C++ host runtime (csrc/host_runtime.cpp) when built."""
    mask = np.asarray(mask, dtype=np.bool_)
    w = num_words(mask.shape[0]) if pad_words is None else pad_words
    from ..runtime import native

    out = native.pack_bits_native(mask.view(np.uint8), w)
    if out is not None:
        return out
    nb = np.packbits(mask, bitorder="little")
    buf = np.zeros(w * 4, dtype=np.uint8)
    buf[: nb.shape[0]] = nb
    return buf.view(np.uint32)


def unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """uint32[W] -> bool[n] (LSB-first)."""
    from ..runtime import native

    out = native.unpack_bits_native(np.ascontiguousarray(words), n)
    if out is not None:
        return out
    by = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(by, count=n, bitorder="little").astype(np.bool_)
