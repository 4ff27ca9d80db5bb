from .driver import DispatchAheadDriver
from .lockstep import (CHECKPOINT_FIELD_DEFAULTS, LaneState, LaneTelemetry,
                       LockstepEngine, telemetry_summary_fn)

__all__ = ["CHECKPOINT_FIELD_DEFAULTS", "DispatchAheadDriver", "LaneState",
           "LaneTelemetry", "LockstepEngine", "telemetry_summary_fn"]
