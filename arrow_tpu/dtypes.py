"""Arrow dtype system for the engine.

Redesign of the reference's dtype layer
(`crates/array/src/array/mod.rs:40-50` ``ArrowType`` enum,
``ArrowPrimitiveType``/``RustNativeType`` traits `mod.rs:52-101`, marker traits
`types.rs:4-23`).  Where the reference maps each dtype to a WGSL shader tree and a
buffer ITEM_SIZE, we map each dtype to a JAX dtype plus semantic flags that drive
dtype-templated op codegen.  Sub-32-bit types are stored natively (XLA handles
int8/int16 tiling) instead of the reference's manual u32 lane packing
(`compute_shaders/u16/utils.wgsl`).

Note: the reference declares ITEM_SIZE=4 for Int16 (`array/mod.rs:83`), which is a
quirk of its packing scheme; here every dtype reports its true byte width.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax.numpy as jnp
import numpy as np


class ArrowType(enum.Enum):
    """The nine dtypes of the reference engine (`array/mod.rs:40-50`)."""

    BOOL = "bool"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    FLOAT32 = "float32"
    DATE32 = "date32"
    # -- extensions beyond the reference (needed by the distributed tier's
    #    1B-row sort/join configs which use 64-bit keys; see BASELINE.md) --
    UINT64 = "uint64"
    INT64 = "int64"
    FLOAT64 = "float64"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ArrowType.{self.name}"


@dataclasses.dataclass(frozen=True)
class DTypeInfo:
    """Static metadata used by the op codegen layer."""

    arrow: ArrowType
    jax: jnp.dtype  # physical storage dtype of the data buffer
    item_size: int  # true byte width (1 for BOOL: bit-packed, see below)
    bit_width: int
    is_float: bool
    is_signed: bool
    is_integer: bool
    is_temporal: bool = False

    @property
    def numpy(self) -> np.dtype:
        return np.dtype(self.jax)


def _info(arrow, jdt, bits, *, f=False, s=False, i=False, t=False) -> DTypeInfo:
    return DTypeInfo(
        arrow=arrow,
        jax=jnp.dtype(jdt),
        item_size=max(1, bits // 8),
        bit_width=bits,
        is_float=f,
        is_signed=s,
        is_integer=i,
        is_temporal=t,
    )


# BOOL is logically 1-bit (bit-packed in uint32 words, Arrow LSB-first layout);
# its "storage" jax dtype below refers to the packed word buffer.
_REGISTRY: dict[ArrowType, DTypeInfo] = {
    ArrowType.BOOL: _info(ArrowType.BOOL, jnp.uint32, 1),
    ArrowType.UINT8: _info(ArrowType.UINT8, jnp.uint8, 8, i=True),
    ArrowType.UINT16: _info(ArrowType.UINT16, jnp.uint16, 16, i=True),
    ArrowType.UINT32: _info(ArrowType.UINT32, jnp.uint32, 32, i=True),
    ArrowType.UINT64: _info(ArrowType.UINT64, jnp.uint64, 64, i=True),
    ArrowType.INT8: _info(ArrowType.INT8, jnp.int8, 8, s=True, i=True),
    ArrowType.INT16: _info(ArrowType.INT16, jnp.int16, 16, s=True, i=True),
    ArrowType.INT32: _info(ArrowType.INT32, jnp.int32, 32, s=True, i=True),
    ArrowType.INT64: _info(ArrowType.INT64, jnp.int64, 64, s=True, i=True),
    ArrowType.FLOAT32: _info(ArrowType.FLOAT32, jnp.float32, 32, f=True, s=True),
    ArrowType.FLOAT64: _info(ArrowType.FLOAT64, jnp.float64, 64, f=True, s=True),
    ArrowType.DATE32: _info(ArrowType.DATE32, jnp.int32, 32, s=True, i=True, t=True),
}


def info(t: ArrowType) -> DTypeInfo:
    return _REGISTRY[t]


def jax_dtype(t: ArrowType) -> jnp.dtype:
    return _REGISTRY[t].jax


def item_size(t: ArrowType) -> int:
    return _REGISTRY[t].item_size


def bit_width(t: ArrowType) -> int:
    return _REGISTRY[t].bit_width


def is_float(t: ArrowType) -> bool:
    return _REGISTRY[t].is_float


def is_integer(t: ArrowType) -> bool:
    return _REGISTRY[t].is_integer


def is_signed(t: ArrowType) -> bool:
    return _REGISTRY[t].is_signed


def is_temporal(t: ArrowType) -> bool:
    return _REGISTRY[t].is_temporal


#: dtypes whose arithmetic reuses the i32 compute path in the reference via
#: marker traits (`array/src/array/types.rs:4-23`): Date32 reuses Int32 kernels.
def compute_type(t: ArrowType) -> ArrowType:
    """The dtype whose kernel family `t` computes with (Date32 -> Int32)."""
    return ArrowType.INT32 if t is ArrowType.DATE32 else t


_FROM_NUMPY: dict[np.dtype, ArrowType] = {
    np.dtype(np.bool_): ArrowType.BOOL,
    np.dtype(np.uint8): ArrowType.UINT8,
    np.dtype(np.uint16): ArrowType.UINT16,
    np.dtype(np.uint32): ArrowType.UINT32,
    np.dtype(np.uint64): ArrowType.UINT64,
    np.dtype(np.int8): ArrowType.INT8,
    np.dtype(np.int16): ArrowType.INT16,
    np.dtype(np.int32): ArrowType.INT32,
    np.dtype(np.int64): ArrowType.INT64,
    np.dtype(np.float32): ArrowType.FLOAT32,
    np.dtype(np.float64): ArrowType.FLOAT64,
}


def from_numpy_dtype(dt) -> ArrowType:
    dt = np.dtype(dt)
    try:
        return _FROM_NUMPY[dt]
    except KeyError:
        raise TypeError(f"no ArrowType for numpy dtype {dt}") from None


# ---------------------------------------------------------------------------
# DataType objects: parity surface with the reference's Python binding
# (`crates/python_wgarrow/src/datatype.rs:10-199` — `_int8()`.. constructors,
# `_is_integer()`-style predicates, bit/byte width getters).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataType:
    """User-facing dtype handle mirroring `wgarrow.DataType`."""

    arrow: ArrowType

    @property
    def bit_width(self) -> int:
        return bit_width(self.arrow)

    @property
    def byte_width(self) -> int:
        return item_size(self.arrow)

    @property
    def num_fields(self) -> int:
        """Child-field count: 0 for every primitive type (≙ reference
        `crates/python_wgarrow/src/datatype.rs:40-53`)."""
        return 0

    def __repr__(self) -> str:
        return f"DataType({self.arrow.value})"

    def __eq__(self, other) -> bool:
        if isinstance(other, DataType):
            return self.arrow is other.arrow
        if isinstance(other, ArrowType):
            return self.arrow is other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.arrow)


def bool_() -> DataType:
    return DataType(ArrowType.BOOL)


def int8() -> DataType:
    return DataType(ArrowType.INT8)


def int16() -> DataType:
    return DataType(ArrowType.INT16)


def int32() -> DataType:
    return DataType(ArrowType.INT32)


def int64() -> DataType:
    return DataType(ArrowType.INT64)


def uint8() -> DataType:
    return DataType(ArrowType.UINT8)


def uint16() -> DataType:
    return DataType(ArrowType.UINT16)


def uint32() -> DataType:
    return DataType(ArrowType.UINT32)


def uint64() -> DataType:
    return DataType(ArrowType.UINT64)


def float32() -> DataType:
    return DataType(ArrowType.FLOAT32)


def float64() -> DataType:
    return DataType(ArrowType.FLOAT64)


def date32() -> DataType:
    return DataType(ArrowType.DATE32)


def is_boolean(t: DataType) -> bool:
    return t.arrow is ArrowType.BOOL


def is_integer_dt(t: DataType) -> bool:
    return is_integer(t.arrow)


def is_signed_integer(t: DataType) -> bool:
    return is_integer(t.arrow) and is_signed(t.arrow)


def is_unsigned_integer(t: DataType) -> bool:
    return is_integer(t.arrow) and not is_signed(t.arrow)


def is_floating(t: DataType) -> bool:
    return is_float(t.arrow)


def is_temporal_dt(t: DataType) -> bool:
    return is_temporal(t.arrow)


def is_primitive(t: DataType) -> bool:
    return t.arrow is not ArrowType.BOOL
