"""Error types (≙ ``ArrowErrorGPU``, `crates/array/src/lib.rs:10-14`)."""

from __future__ import annotations


class ArrowTpuError(Exception):
    """Base error."""


class OperationNotSupported(ArrowTpuError):
    """Op not registered for the given dtype(s) — ≙ the reference's
    ``ArrowErrorGPU::OperationNotSupported`` and its `_dyn` macro panics."""


class CastingNotSupported(ArrowTpuError):
    """Cast pair not registered — ≙ ``ArrowErrorGPU::CastingNotSupported``."""
