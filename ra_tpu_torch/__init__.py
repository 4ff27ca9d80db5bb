"""ra_tpu_torch: the PyTorch/CUDA port of ra-tpu.

A second package beside ``ra_tpu`` (the JAX reference, which it never
imports).  Two planes:

* the lockstep lane engine: thousands of co-hosted Raft clusters
  advanced as one batched step on an NVIDIA H100, with the commit quorum
  in a hand-written Hopper kernel and K steps a dispatch replayed as one
  CUDA graph; in durable mode (``open_engine``) commits gate on fsync
  confirms from a sharded WAL; the ingress and wire planes carry client
  sessions over sockets into it; an Observatory, an SLO engine and an
  autotuner watch and steer the loop;
* the classic replicated plane: one ``RaServer`` (the pure Raft core) a
  member, hosted by a ``RaNode`` over a ``LocalRouter``, with a
  ``RaSystem`` (one shared WAL, segments and snapshots a node, its
  ``Directory``) and the public verbs of ``api`` (``start_cluster``,
  ``process_command``, ``consistent_query``, ``add_member``, ...).  A
  ``JitMachine`` runs there too, one command at a time on its device.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (on the classic plane: ``RaNode(..., device=...)``,
which a JitMachine's ``init`` reads).  Exports are lazy, so ``import
ra_tpu_torch`` loads nothing but this file and starts no compiler.
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
    "Observatory": "ra_tpu_torch.telemetry",
    "SloEngine": "ra_tpu_torch.slo",
    "AutoTuner": "ra_tpu_torch.autotune",
    "CounterMachine": "ra_tpu_torch.models.counter",
    "JitFifoMachine": "ra_tpu_torch.models.jit_fifo",
    "JitKvMachine": "ra_tpu_torch.models.jit_kv",
    "RegisterMachine": "ra_tpu_torch.models.registers",
    "TtlKvMachine": "ra_tpu_torch.models.ttl_kv",
    "StreamMachine": "ra_tpu_torch.models.stream",
    "DedupCounterMachine": "ra_tpu_torch.wire.dedup",
    "IngressPlane": "ra_tpu_torch.ingress",
    "WireListener": "ra_tpu_torch.wire.server",
    "WireClient": "ra_tpu_torch.wire.client",
    "LoopbackFleet": "ra_tpu_torch.wire.client",
    "run_wire_soak": "ra_tpu_torch.wire.soak",
    "JitMachine": "ra_tpu_torch.core.machine",
    "resolve_device": "ra_tpu_torch.device",
    "RaNode": "ra_tpu_torch.node",
    "LocalRouter": "ra_tpu_torch.node",
    "RaSystem": "ra_tpu_torch.system",
    "Directory": "ra_tpu_torch.directory",
    "KvMachine": "ra_tpu_torch.models.kv",
    "FifoMachine": "ra_tpu_torch.models.fifo",
    "QueueMachine": "ra_tpu_torch.models.queue",
    "add_member": "ra_tpu_torch.api",
    "aux_command": "ra_tpu_torch.api",
    "cast_aux_command": "ra_tpu_torch.api",
    "consistent_query": "ra_tpu_torch.api",
    "delete_cluster": "ra_tpu_torch.api",
    "force_delete_server": "ra_tpu_torch.api",
    "force_shrink_members_to_current_member": "ra_tpu_torch.api",
    "key_metrics": "ra_tpu_torch.api",
    "leader_query": "ra_tpu_torch.api",
    "local_query": "ra_tpu_torch.api",
    "member_overview": "ra_tpu_torch.api",
    "members": "ra_tpu_torch.api",
    "members_info": "ra_tpu_torch.api",
    "new_uid": "ra_tpu_torch.api",
    "node_call": "ra_tpu_torch.api",
    "overview": "ra_tpu_torch.api",
    "ping": "ra_tpu_torch.api",
    "pipeline_command": "ra_tpu_torch.api",
    "pipeline_commands": "ra_tpu_torch.api",
    "process_command": "ra_tpu_torch.api",
    "remove_member": "ra_tpu_torch.api",
    "restart_server": "ra_tpu_torch.api",
    "start_cluster": "ra_tpu_torch.api",
    "start_server": "ra_tpu_torch.api",
    "stop_server": "ra_tpu_torch.api",
    "transfer_leadership": "ra_tpu_torch.api",
    "trigger_election": "ra_tpu_torch.api",
}

#: submodules exported by name, as ``ra_tpu.aux``
_MODULES = {"aux": "ra_tpu_torch.core.aux"}

__all__ = sorted(_EXPORTS) + sorted(_MODULES)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in _MODULES:
        return importlib.import_module(_MODULES[name])
    raise AttributeError(f"module 'ra_tpu_torch' has no attribute {name!r}")
