from .driver import DispatchAheadDriver
from .lockstep import (CHECKPOINT_FIELD_DEFAULTS, LaneState, LaneTelemetry,
                       LockstepEngine, telemetry_summary_fn)

__all__ = ["CHECKPOINT_FIELD_DEFAULTS", "DispatchAheadDriver",
           "EngineDurability", "LaneState", "LaneTelemetry",
           "LockstepEngine", "open_engine", "telemetry_summary_fn"]

#: the durable engine loads on first use (it brings the WAL plane)
_LAZY = {"EngineDurability", "open_engine"}


def __getattr__(name: str):
    if name in _LAZY:
        from . import durable
        return getattr(durable, name)
    raise AttributeError(
        f"module 'ra_tpu_torch.engine' has no attribute {name!r}")
