"""Deterministic transport fault plans: the fault-plan registry of
``ra_tpu/transport/rpc.py``.

A :class:`FaultPlan` is a seeded fault schedule (drop / delay /
duplicate / reorder probabilities per peer and frame class, partitions,
latency-domain matrices) that a transport consults.  Every plan registers
itself in a weakly held live set: post-mortem bundles name the live plans
(the ``net_fault_plans`` source), and the autotuner's freeze guard reads
:func:`live_fault_plans` and each plan's :meth:`FaultPlan.quiet` (a
controller must never chase chaos-injected latency with knob turns).  The
wire soak registers a lossy plan for the length of its run, as the
reference does.

Ported with the plan: its specs, the registry, ``quiet``,
``unregister``, ``partition``/``heal`` and ``overview``.  The per-frame
decision (``decide``) and the reliable RPC around it belong to the host
transport, which is not ported: no transport of the port consults a plan.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

from ..blackbox import RECORDER

__all__ = ["FaultDecision", "FaultPlan", "FaultSpec", "live_fault_plans"]


@dataclass(frozen=True)
class FaultSpec:
    """Per-stream fault probabilities.  ``limit`` bounds the TOTAL
    number of faults this spec may inject on one stream (0 = unbounded)
    — a limit of 3 with drop=1.0 means 'drop exactly the first three
    frames', which is how tests script deterministic scenarios."""

    drop: float = 0.0
    delay: float = 0.0
    delay_ms: tuple = (1.0, 10.0)
    duplicate: float = 0.0
    reorder: float = 0.0
    limit: int = 0


@dataclass(frozen=True)
class FaultDecision:
    action: str = "deliver"        # "deliver" | "drop"
    delay_s: float = 0.0
    duplicate: bool = False
    reorder: bool = False


#: live FaultPlans (weak: a dropped plan leaves the bundle) — the
#: "active FaultPlan state" source every post-mortem bundle embeds
_LIVE_PLANS: "weakref.WeakSet" = weakref.WeakSet()
RECORDER.add_source(
    "net_fault_plans",
    lambda: [p.overview() for p in list(_LIVE_PLANS)])


def live_fault_plans() -> list:
    """The transport FaultPlans still alive in this process — what the
    post-mortem bundle source embeds, and the autotuner's freeze guard
    reads ("hard freeze while any FaultPlan is active": a controller
    must never chase chaos-injected latency with knob turns).  Weakly
    tracked: a plan with no remaining strong referent drops out."""
    return list(_LIVE_PLANS)


class FaultPlan:
    """Seeded fault schedule consulted by a transport.

    Specs by ``(peer, frame_class)``, ``peer``, ``frame_class`` and a
    default.  Frame classes: ``msg`` (Raft data), ``rpc_req``/``rpc_resp``
    (control plane), ``reply``, ``notify``, ``ping``, ``hello``.
    Partitions are binary per peer until :meth:`heal`.

    **Latency domains**: ``domains`` declares a named-domain delay matrix
    so a whole geo topology is one object::

        FaultPlan(seed, domains={
            "local": "ctl",                        # where THIS plan runs
            "members": {"ctl": ["ctl0"],
                        "geo": ["gf1", "gf2"],
                        "eng": ["engA", "engB"]},
            "matrix": {("ctl", "geo"):             # per (src, dst) pair
                       {"delay_ms": 80.0, "jitter_ms": 70.0}},
        })

    Matrix values are :class:`FaultSpec` objects or dicts compiled to
    one (``delay_ms`` as a number with optional ``jitter_ms``, or an
    explicit ``(lo, hi)`` tuple; optional ``drop`` probability; a pure
    delay spec gets ``delay=1.0`` — network distance is deterministic,
    not probabilistic).
    """

    def __init__(self, seed: int = 0,
                 default: Optional[FaultSpec] = None,
                 by_class: Optional[dict] = None,
                 by_peer: Optional[dict] = None,
                 by_peer_class: Optional[dict] = None,
                 domains: Optional[dict] = None) -> None:
        self.seed = seed
        self.default = default or FaultSpec()
        self.by_class = dict(by_class or {})
        self.by_peer = dict(by_peer or {})
        self.by_peer_class = dict(by_peer_class or {})
        self.partitioned: set = set()
        #: injected-fault counters by kind (drop/delay/duplicate/
        #: reorder/partition), for the transport that consults the plan
        self.counters: dict = {}
        self.domains = dict(domains or {})
        self._local_domain = self.domains.get("local", "")
        #: (src, dst) -> FaultSpec (compiled from domains["matrix"])
        self._matrix: dict = {
            tuple(pair): self._compile_domain_spec(v)
            for pair, v in self.domains.get("matrix", {}).items()}
        _LIVE_PLANS.add(self)  # post-mortem bundles name active plans

    @staticmethod
    def _compile_domain_spec(value) -> FaultSpec:
        """A matrix cell → FaultSpec.  Dicts name network distance
        declaratively: ``delay_ms`` (number → uniform over
        [delay, delay + jitter_ms], or an explicit (lo, hi) tuple) and
        an optional ``drop`` probability.  Any nonzero delay range gets
        probability 1.0 — every frame crossing the boundary pays the
        distance."""
        if isinstance(value, FaultSpec):
            return value
        v = dict(value)
        delay_ms = v.get("delay_ms", 0.0)
        if isinstance(delay_ms, (tuple, list)):
            lo, hi = float(delay_ms[0]), float(delay_ms[1])
        else:
            lo = float(delay_ms)
            hi = lo + float(v.get("jitter_ms", 0.0))
        drop = float(v.get("drop", 0.0))
        return FaultSpec(drop=drop,
                         delay=1.0 if hi > 0.0 else 0.0,
                         delay_ms=(lo, hi))

    # -- schedule control ---------------------------------------------------

    def quiet(self) -> bool:
        """True when this plan can no longer inject anything: every
        spec carries zero probabilities and no partition is standing.
        A healed partition-only plan, or an all-defaults plan, is
        quiet — the autotuner's freeze guard reads this, because a
        plan object pinned by a router after the chaos exercise ended
        must not freeze the controller for the rest of the process
        (liveness is not activity).  Domain matrices are judged from
        THIS plan's vantage: only cells touching the local domain can
        ever inject here, so a standing 100 ms control-tier matrix
        leaves an engine-tier plan (same topology, different
        ``local``) quiet — the freeze guard must not freeze the
        engine hosts' tuners for latency they never see."""
        if self.partitioned:
            return False
        specs = [self.default, *self.by_class.values(),
                 *self.by_peer.values(), *self.by_peer_class.values()]
        specs += [spec for (src, dst), spec in self._matrix.items()
                  if self._local_domain in (src, dst)]
        return all(s.drop == 0 and s.delay == 0 and s.duplicate == 0
                   and s.reorder == 0 for s in specs)

    def unregister(self) -> None:
        """Drop this plan from the live-plan registry (the bundle
        source and the autotuner freeze guard stop seeing it) without
        disturbing transports still holding it.  Test scoping uses
        this: the registry is process-global and weakly held, so a
        plan pinned by a leaked router would otherwise freeze every
        later tuner and skip the quiet-plan probes — conftest
        unregisters plans a test created once the test ends."""
        _LIVE_PLANS.discard(self)

    def partition(self, peer: str) -> None:
        self.partitioned.add(peer)

    def heal(self, peer: Optional[str] = None) -> None:
        if peer is None:
            self.partitioned.clear()
        else:
            self.partitioned.discard(peer)

    def overview(self) -> dict:
        out = {"seed": self.seed,
               "partitioned": sorted(self.partitioned),
               "injected": dict(self.counters)}
        if self._matrix:
            out["local_domain"] = self._local_domain
            out["domain_matrix"] = sorted(
                f"{src}->{dst}" for src, dst in self._matrix)
        return out
