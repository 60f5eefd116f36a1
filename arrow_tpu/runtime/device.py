"""Device management.

Replacement for the reference's ``GpuDevice``
(`crates/array/src/gpu_utils/gpu_device.rs:29-84`): adapter/queue
acquisition becomes JAX platform/device selection; explicit buffer create/upload/
readback (`gpu_device.rs:171-265`) becomes `jax.device_put` / `np.asarray` with
XLA managing the device allocator; the compiled-pipeline cache keyed by shader source
(`gpu_device.rs:145-168`, `append_hashmap.rs:9-34`) becomes the lru jit caches in
`arrow_tpu.ops.kernel` (`_eager_jit`) and `arrow_tpu.runtime.pipeline` (graph
signature cache).

Like the reference's process-wide ``GPU_DEVICE`` singleton
(`crates/array/src/lib.rs:17`), a lazily-created default :class:`Device` backs all
arrays unless one is passed explicitly.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import jax
import numpy as np

log = logging.getLogger("arrow_tpu")


class Device:
    """A compute device handle (one JAX device, usually a GPU)."""

    def __init__(self, jax_device: Optional[jax.Device] = None):
        if jax_device is None:
            jax_device = jax.devices()[0]
        self.jax_device = jax_device
        log.info("arrow_tpu device: %s (%s)", jax_device, jax_device.platform)

    @property
    def platform(self) -> str:
        return self.jax_device.platform

    # --- buffer management (≙ gpu_device.rs:171-265) -----------------------

    def put(self, host: np.ndarray) -> jax.Array:
        """Host -> device transfer (≙ ``create_gpu_buffer_with_data``)."""
        return jax.device_put(host, self.jax_device)

    def get(self, buf: jax.Array) -> np.ndarray:
        """Blocking device -> host readback (≙ ``retrive_data``
        `gpu_device.rs:232-265`)."""
        return np.asarray(buf)

    def synchronize(self) -> None:
        """Drain all in-flight work on this device."""
        jax.block_until_ready(jax.device_put(0, self.jax_device))

    def memory_stats(self) -> dict:
        try:
            return self.jax_device.memory_stats() or {}
        except Exception:  # pragma: no cover - platform-dependent
            return {}

    def __repr__(self) -> str:
        return f"Device({self.jax_device})"


_default_lock = threading.Lock()
_default_device: Optional[Device] = None


def default_device() -> Device:
    """Process-wide device singleton (≙ ``GPU_DEVICE`` `array/src/lib.rs:17`)."""
    global _default_device
    if _default_device is None:
        with _default_lock:
            if _default_device is None:
                _default_device = Device()
    return _default_device


def set_default_device(device: Device) -> None:
    global _default_device
    with _default_lock:
        _default_device = device
