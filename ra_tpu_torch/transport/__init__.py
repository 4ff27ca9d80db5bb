"""The transport plane of the port: the reliable control-plane RPC and
the deterministic fault plans (``rpc.py``), and the TCP fabric between
OS processes (``tcp.py``: ``TcpRouter``, with its failure detector)."""
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
from .tcp import TcpRouter  # noqa: F401

__all__ = ["FaultDecision", "FaultPlan", "FaultSpec", "RemoteError",
           "RpcError", "RpcTimeout", "TcpRouter", "Unreachable",
           "live_fault_plans", "reliable_node_call"]
