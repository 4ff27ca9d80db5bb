from .lockstep import (CHECKPOINT_FIELD_DEFAULTS, LaneState, LaneTelemetry,
                       LockstepEngine)

__all__ = ["CHECKPOINT_FIELD_DEFAULTS", "LaneState", "LaneTelemetry",
           "LockstepEngine"]
