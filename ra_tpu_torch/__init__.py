"""ra_tpu_torch: the PyTorch/CUDA port of ra-tpu's lockstep lane engine.

A second package beside ``ra_tpu`` (the JAX reference, which it never
imports): thousands of co-hosted Raft clusters advanced as one batched
step on an NVIDIA H100, with the commit quorum in a hand-written Hopper
kernel and K steps a dispatch replayed as one CUDA graph; in durable mode
(``open_engine``) commits gate on fsync confirms from a sharded WAL.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Exports are lazy, so ``import ra_tpu_torch`` loads
nothing but this file and starts no compiler.
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "LockstepEngine": "ra_tpu_torch.engine.lockstep",
    "LaneState": "ra_tpu_torch.engine.lockstep",
    "DispatchAheadDriver": "ra_tpu_torch.engine.driver",
    "EngineDurability": "ra_tpu_torch.engine.durable",
    "open_engine": "ra_tpu_torch.engine.durable",
    "TelemetrySampler": "ra_tpu_torch.telemetry",
    "CounterMachine": "ra_tpu_torch.models.counter",
    "JitMachine": "ra_tpu_torch.core.machine",
    "resolve_device": "ra_tpu_torch.device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'ra_tpu_torch' has no attribute {name!r}")
