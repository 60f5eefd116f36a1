"""Runtime configuration.

The reference hard-codes its tuning constants (workgroup size 256 everywhere,
`gpu_device.rs:304`; HighPerformance power preference `gpu_device.rs:51`).  This
engine exposes them as a real config layer (SURVEY.md §5 "the build will need a real
config layer") so buffer padding, the mesh axis and profiling are settable
without code edits.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # --- layout ---
    #: element padding unit for 1-D column buffers: lengths round up to a
    #: multiple of it, so one compiled program serves every length in a
    #: bucket (at most 32 KB of padding per 4-byte column).
    pad_unit: int = 8192

    # --- distribution ---
    #: default data-partition mesh axis name.
    shard_axis: str = "x"

    # --- misc ---
    #: collect per-op timing (the reference's `profile` cargo feature).
    profile: bool = bool(int(os.environ.get("ARROW_TPU_PROFILE", "0")))


config = Config()


def set_config(**kwargs) -> Config:
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(config, k, v)
    return config
