"""The transport plane of the port: so far only its deterministic fault
plans (``rpc.py``); the reliable RPC and the TCP router of
``ra_tpu/transport`` belong to the host planes and are not ported."""
from .rpc import FaultDecision, FaultPlan, FaultSpec, live_fault_plans

__all__ = ["FaultDecision", "FaultPlan", "FaultSpec", "live_fault_plans"]
