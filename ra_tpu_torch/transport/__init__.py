"""The transport plane of the port: the reliable control-plane RPC and
the deterministic fault plans (``rpc.py``).  The reference's TCP router
(``ra_tpu/transport/tcp.py``) is not ported yet."""
from .rpc import (  # noqa: F401
    FaultDecision,
    FaultPlan,
    FaultSpec,
    RemoteError,
    RpcError,
    RpcTimeout,
    Unreachable,
    live_fault_plans,
    reliable_node_call,
)

__all__ = ["FaultDecision", "FaultPlan", "FaultSpec", "RemoteError",
           "RpcError", "RpcTimeout", "Unreachable", "live_fault_plans",
           "reliable_node_call"]
