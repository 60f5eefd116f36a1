"""Bindings to the C++ host runtime (csrc/host_runtime.cpp), with numpy fallback.

The reference's host tier is native Rust: the CPU packing loop of
``from_optional_slice`` (`crates/array/src/array/primitive_array_gpu.rs:33-43`)
and the bit builder (`null_bit_buffer.rs:10-62`).  Our host tier is C++ exposed via
ctypes: a single pass over a Python sequence of optionals producing the dense value
buffer + validity mask, which is the hot host-side loop on the upload path.

If the shared library hasn't been built (`make -C csrc`), a vectorized numpy
fallback is used; results are identical.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Iterable, Optional, Tuple

import numpy as np

log = logging.getLogger("arrow_tpu")

_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "csrc",
            "libarrowtpu_host.so",
        )
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.atpu_pack_bits.restype = None
                lib.atpu_pack_bits.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                    ctypes.c_void_p,
                ]
                lib.atpu_unpack_bits.restype = None
                lib.atpu_unpack_bits.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                    ctypes.c_void_p,
                ]
                lib.atpu_popcount.restype = ctypes.c_uint64
                lib.atpu_popcount.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
                lib.atpu_and_words.restype = None
                lib.atpu_and_words.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                    ctypes.c_void_p,
                ]
                _LIB = lib
                log.info("arrow_tpu: loaded C++ host runtime %s", path)
            except OSError as e:  # pragma: no cover
                log.warning("arrow_tpu: failed to load host runtime: %s", e)
    return _LIB


def have_native() -> bool:
    return _lib() is not None


def densify_optionals(
    values: Iterable[Optional[object]], np_dtype
) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """One pass over optionals -> (dense values w/ 0 at nulls, bool valid mask, n).

    mask is None when the input is a plain ndarray / contains no Nones.
    """
    if isinstance(values, np.ndarray):
        if values.dtype == object:
            values = values.tolist()
        else:
            arr = values.astype(np_dtype) if np_dtype is not None else values
            return arr, None, arr.shape[0]
    vals = list(values)
    n = len(vals)
    mask = np.fromiter((v is not None for v in vals), count=n, dtype=np.bool_)
    if mask.all():
        arr = np.asarray(vals, dtype=np_dtype)
        return arr, None, n
    dense = np.asarray([0 if v is None else v for v in vals], dtype=np_dtype)
    return dense, mask, n


def pack_bits_native(mask: np.ndarray, pad_words: int) -> Optional[np.ndarray]:
    """C++ bit packing; None if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.zeros(pad_words, dtype=np.uint32)
    lib.atpu_pack_bits(
        mask.ctypes.data_as(ctypes.c_void_p),
        mask.shape[0],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def unpack_bits_native(words: np.ndarray, n: int) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.zeros(n, dtype=np.uint8)
    lib.atpu_unpack_bits(
        words.ctypes.data_as(ctypes.c_void_p),
        n,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out.view(np.bool_)


def popcount_native(words: np.ndarray) -> Optional[int]:
    """Host-side set-bit count over packed u32 words (validity null_count on
    readback/export paths); None if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return int(
        lib.atpu_popcount(words.ctypes.data_as(ctypes.c_void_p), words.shape[0])
    )


def and_words_native(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Host-side AND-merge of two packed word buffers (the host analog of the
    device validity merge, ≙ `null_bit_buffer.rs:168-204`); None if the
    native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    assert a.shape == b.shape
    out = np.empty_like(a)
    lib.atpu_and_words(
        a.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p),
        a.shape[0],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
