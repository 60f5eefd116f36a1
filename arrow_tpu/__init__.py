"""arrow_tpu — a vectorized Arrow compute engine on JAX/XLA.

A JAX/XLA design with the capabilities of psvri/arrow-gpu (see SURVEY.md for the
structural map): columnar arrays in device memory (dense padded value buffers +
packed validity bitmaps), an elementwise kernel tier lowered to fused XLA
programs, a sort-based operator tier (filter, sort, group-by, join), and a
distributed layer (mesh-sharded tables + all-to-all shuffles) the reference
does not have.

Public surface (≙ the umbrella crate `crates/arrow/src/lib.rs:1-3`):

    import arrow_tpu as at
    a = at.Float32Array.from_slice([1.0, 2.0, 3.0])
    b = at.kernels.add_scalar(a, 10.0)
    b.values()
"""

# 64-bit dtypes (u64 keys for the distributed join/sort tier) require x64.
import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compile cache.  JAX_COMPILATION_CACHE_DIR, when set, is JAX's own
# setting and wins.  Otherwise executables go to <checkout>/.jax_cache: a fixed
# path, because the path is part of the cache key.  CPU-only processes (tests,
# the virtual-device dry run) skip the cache: XLA:CPU entries record the
# compiling machine's CPU features and can SIGILL when replayed on another host.
_platforms = _jax.config.jax_platforms
_cpu_only = "xla_force_host_platform_device_count" in _os.environ.get(
    "XLA_FLAGS", ""
) or (_platforms and "cuda" not in _platforms and "gpu" not in _platforms)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and not _cpu_only:
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from . import dtypes  # noqa: E402
from .array import (  # noqa: E402,F401
    ArrowArray,
    ArrowArrayBase,
    BitBufferBuilder,
    BooleanArray,
    Buffer,
    Date32Array,
    Float32Array,
    Float64Array,
    Int8Array,
    Int16Array,
    Int32Array,
    Int64Array,
    NullBitBuffer,
    PrimitiveArray,
    Scalar,
    UInt8Array,
    UInt16Array,
    UInt32Array,
    UInt64Array,
    make_array,
)
from .dtypes import ArrowType, DataType  # noqa: E402
from .errors import ArrowTpuError, CastingNotSupported, OperationNotSupported  # noqa: E402
from .runtime import (  # noqa: E402
    ComputePipeline,
    Device,
    LazyArray,
    default_device,
    set_default_device,
)

from . import kernels  # noqa: E402  (after array types; registers all ops)
from .config import config, set_config  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ArrowArray",
    "ArrowArrayBase",
    "ArrowType",
    "ArrowTpuError",
    "BitBufferBuilder",
    "BooleanArray",
    "Buffer",
    "CastingNotSupported",
    "ComputePipeline",
    "DataType",
    "Date32Array",
    "Device",
    "Float32Array",
    "Float64Array",
    "Int8Array",
    "Int16Array",
    "Int32Array",
    "Int64Array",
    "LazyArray",
    "NullBitBuffer",
    "OperationNotSupported",
    "PrimitiveArray",
    "Scalar",
    "UInt8Array",
    "UInt16Array",
    "UInt32Array",
    "UInt64Array",
    "config",
    "default_device",
    "dtypes",
    "kernels",
    "make_array",
    "set_config",
    "set_default_device",
]
