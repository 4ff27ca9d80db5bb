"""Placement failover: the classic control plane re-homing lane engines;
the port's copy of ``ra_tpu/placement``, on the card.

* :mod:`.table`: the replicated PlacementTable machine (lane range →
  engine + generation), the one authority on placement, and its caches.
* :mod:`.supervisor`: heartbeats engines up → suspect → down with
  hysteresis, commits generation-gated migrations through the table.
* :mod:`.host`: one engine id's serving stack (durable engine, ingress
  plane, wire listener) with kill-9 and adoption of a victim's directory.
* :mod:`.fabric`: the probe, adopt and re-home paths over the reliable
  control-plane RPC tier (``host_*`` verbs).
* :mod:`.soak`: all of it under live wire traffic with a mid-traffic
  kill-9, held to the exactly-once oracle over both engines.
* :mod:`.geo`: the same across four OS processes over TCP, the control
  followers behind a latency-domain matrix and the lane engines in two
  engine children on the card, a SIGKILL'd child's directory adopted by
  the other.
"""
from .table import (MACHINE_NAME, PlacementCache, PlacementTableMachine,
                    owned_ranges, placement_spec)
from .supervisor import EngineSupervisor, PlacementError
from .host import LaneEngineHost
from .fabric import (HostAgent, RpcEngineProbe, push_placement,
                     remote_adopt, remote_lane_sums, remote_rehome)
from .soak import run_failover_soak
from .geo import run_geo_soak

__all__ = ["MACHINE_NAME", "PlacementTableMachine", "PlacementCache",
           "placement_spec", "owned_ranges", "EngineSupervisor",
           "PlacementError", "LaneEngineHost", "HostAgent",
           "RpcEngineProbe", "remote_adopt", "remote_rehome",
           "remote_lane_sums", "push_placement", "run_failover_soak",
           "run_geo_soak"]
