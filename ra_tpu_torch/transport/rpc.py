"""Reliable control-plane RPC and deterministic transport fault plans:
the port's own copy of ``ra_tpu/transport/rpc.py``.

* **Sender**: :func:`reliable_node_call` -- per-request ids, retry with
  exponential backoff and jitter, deadline propagation, reconnect-aware
  routing and typed failures (:class:`Unreachable`, :class:`RpcTimeout`,
  :class:`RemoteError`) instead of a silent hang.  ``api.node_call``
  reaches it for a node its router cannot reach in process.
* **Receiver**: :class:`RpcReceiver` -- an at-most-once execution guard:
  a bounded LRU of request ids maps retries of an executed request onto
  its cached response, and retries of an in-flight one onto nothing.

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
``unregister``, ``partition``/``heal``, ``overview`` and the per-frame
decision (``decide``, ``is_partitioned``, ``recv_peer``) on the same
seeded per-(peer, frame class, direction) streams as the reference's.
The placement supervisor consults ``decide`` for its probes, and
``transport/tcp.py``'s ``TcpRouter`` on every frame it sends or
receives.
"""
from __future__ import annotations

import random
import threading
import time
import uuid
import weakref
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

from .. import trace
from ..blackbox import RECORDER, record

__all__ = [
    "FaultDecision",
    "FaultPlan",
    "FaultSpec",
    "RemoteError",
    "RpcError",
    "RpcReceiver",
    "RpcRequest",
    "RpcResponse",
    "RpcTimeout",
    "Unreachable",
    "live_fault_plans",
    "reliable_node_call",
    "stamp_origin",
]

# ---------------------------------------------------------------------------
# Error surfaces (ra.erl's {error, noproc|nodedown|timeout} triad)
# ---------------------------------------------------------------------------

class RpcError(RuntimeError):
    """Base class for control-plane RPC failures."""


class Unreachable(RpcError):
    """The target node cannot be reached: no route, or the failure
    detector holds it suspect/down at the deadline (nodedown)."""


class RpcTimeout(RpcError, TimeoutError):
    """The call's deadline elapsed while the peer looked reachable —
    requests were sent but no response arrived in time."""


class RemoteError(RpcError):
    """The remote executor itself failed; carries the remote repr."""


# ---------------------------------------------------------------------------
# Wire records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RpcRequest:
    """One control-plane request.  ``rid`` is stable across retries —
    it is the at-most-once dedup key.  ``deadline_unix`` propagates the
    caller's remaining budget (wall clock: monotonic clocks are not
    comparable across processes; cross-host skew makes this advisory)."""

    rid: str
    node: str                 # target node name (the $node scope)
    op: str
    args: dict
    deadline_unix: float = 0.0
    attempt: int = 1
    origin: tuple = ()        # sender's listen addr, filled by transport
    origin_router: str = ""   # sender's router id (wildcard-bind safe)
    #: causal trace context: minted at the sender's ingress,
    #: STABLE across retries like ``rid`` — a duplicate delivery dedups
    #: receiver-side and records as a ``rpc.dup`` event under the same
    #: trace id, so at-most-once execution is visible, not just true
    trace_ctx: str = ""


@dataclass(frozen=True)
class RpcResponse:
    rid: str
    ok: bool
    value: Any = None
    error: str = ""
    #: a retryable failure means "not executed, try again" (e.g. the
    #: target RaNode is not registered on that host YET — a restarting
    #: worker); non-retryable means the executor crashed or refused
    retryable: bool = False


# ---------------------------------------------------------------------------
# Receiver-side at-most-once guard
# ---------------------------------------------------------------------------

class RpcReceiver:
    """Dedup/response cache giving retried requests at-most-once
    execution.  ``execute(req, done)`` starts the operation and calls
    ``done(result)`` exactly once when finished; it returns False when
    the target is not hosted here (retryable, NOT cached — a later
    retry may find the node registered)."""

    CACHE_MAX = 1024

    def __init__(self, execute: Callable[[RpcRequest, Callable], bool],
                 counters: Optional[dict] = None) -> None:
        self._execute = execute
        self._cache: OrderedDict = OrderedDict()  # rid -> (status, resp)
        self._lock = threading.Lock()
        self.counters = counters if counters is not None else {}

    def _note(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def handle(self, req: RpcRequest,
               respond: Callable[[RpcResponse], None]) -> None:
        with self._lock:
            ent = self._cache.get(req.rid)
            if ent is not None:
                # a retry of something we already saw: never re-execute
                self._cache.move_to_end(req.rid)
                self._note("rpc_dedup_hits")
                # the duplicate delivery is VISIBLE under the same
                # trace id while the verb still runs at most once
                record("rpc.dup", trace=req.trace_ctx, rid=req.rid,
                       op=req.op, attempt=req.attempt)
                status, resp = ent
                if status == "done":
                    self._note("rpc_responses_resent")
                    respond(resp)
                # in-flight: say nothing — completion will respond, and
                # any later retry lands on the cached response
                return
            self._cache[req.rid] = ("running", None)
            while len(self._cache) > self.CACHE_MAX:
                # evict oldest DONE entry only: evicting a 'running'
                # rid would let its retry re-execute the verb — the
                # exact double-execution this cache exists to prevent.
                # If everything is in flight the cache grows past the
                # cap, bounded by concurrent executions.
                for key, (status, _resp) in self._cache.items():
                    if status != "running":
                        del self._cache[key]
                        break
                else:
                    break
        if req.deadline_unix and time.time() > req.deadline_unix:
            # the sender's budget is spent: executing now could only
            # produce a zombie side effect nobody awaits
            self._note("rpc_expired")
            record("rpc.expired", trace=req.trace_ctx, rid=req.rid,
                   op=req.op)
            resp = RpcResponse(req.rid, ok=False, error="deadline_expired")
            with self._lock:
                self._cache[req.rid] = ("done", resp)
            respond(resp)
            return

        def done(result: Any) -> None:
            resp = RpcResponse(req.rid, ok=True, value=result)
            with self._lock:
                self._cache[req.rid] = ("done", resp)
            respond(resp)

        self._note("rpc_requests_executed")
        record("rpc.recv", trace=req.trace_ctx, rid=req.rid, op=req.op,
               attempt=req.attempt)
        try:
            started = self._execute(req, done)
        except Exception as exc:  # noqa: BLE001 — travels to the caller
            resp = RpcResponse(req.rid, ok=False, error=repr(exc)[:400])
            with self._lock:
                self._cache[req.rid] = ("done", resp)
            respond(resp)
            return
        if not started:
            # target node not hosted here (yet): forget the rid so a
            # retry can execute once it registers, and tell the sender
            # to keep trying
            self._note("rpc_requests_executed", -1)
            with self._lock:
                self._cache.pop(req.rid, None)
            respond(RpcResponse(req.rid, ok=False, retryable=True,
                                error=f"node {req.node!r} not hosted"))

    def overview(self) -> dict:
        with self._lock:
            return {"cached": len(self._cache), **dict(self.counters)}


# ---------------------------------------------------------------------------
# Sender-side retry loop
# ---------------------------------------------------------------------------

#: per-attempt response wait: grows exponentially from FIRST to CAP so a
#: lost first request retries fast while a genuinely slow executor
#: (start_server recovering a long log) is not hammered
ATTEMPT_WAIT_FIRST = 0.3
ATTEMPT_WAIT_CAP = 3.0
#: sleep between attempts: exponential with full jitter, capped
BACKOFF_FIRST = 0.05
BACKOFF_CAP = 1.0


def _attempt_wait(attempt: int) -> float:
    return min(ATTEMPT_WAIT_FIRST * (2 ** (attempt - 1)), ATTEMPT_WAIT_CAP)


def reliable_node_call(router, node: str, op: str, args: dict,
                       timeout: float = 60.0,
                       trace_ctx: Optional[str] = None) -> Any:
    """Call ``op`` on ``node``'s control plane with retries, dedup and
    typed failures — the rpc:call-over-distribution role.  The router
    must provide the RPC transport surface (TcpRouter does); a router
    without it (LocalRouter reaching for a remote node) is Unreachable
    by construction.  A trace context (minted here if the caller did
    not propagate one) rides every attempt's frame: retries and
    duplicate deliveries record under ONE id."""
    if getattr(router, "rpc_register", None) is None:
        raise Unreachable(
            f"node {node} is unreachable for {op}: router has no RPC "
            "transport (in-process LocalRouter has no remote reach)")
    if not router.rpc_routable(node):
        router.rpc_note("rpc_unreachable")
        raise Unreachable(
            f"node {node} is unreachable for {op}: not in the address "
            "book")
    router.rpc_note("rpc_calls")
    rid = uuid.uuid4().hex
    ctx = trace_ctx or trace.new_trace_ctx()
    rng = random.Random(rid)
    deadline = time.monotonic() + timeout
    fut = router.rpc_register(rid)
    attempt = 0
    try:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            attempt += 1
            if attempt > 1:
                router.rpc_note("rpc_retries")
                # reconnect-aware routing: a cached connection to a
                # peer the detector suspects is exactly the half-dead
                # socket that eats one-shot sends
                router.rpc_invalidate_peer(node)
            req = RpcRequest(rid=rid, node=node, op=op, args=dict(args),
                             deadline_unix=time.time() + remaining,
                             attempt=attempt, trace_ctx=ctx)
            record("rpc.send", trace=ctx, rid=rid, op=op, node=node,
                   attempt=attempt)
            router.rpc_send(node, req)
            try:
                resp = fut.wait(min(_attempt_wait(attempt), remaining))
            except TimeoutError:
                pause = rng.uniform(0.5, 1.0) * min(
                    BACKOFF_FIRST * (2 ** (attempt - 1)), BACKOFF_CAP)
                pause = min(pause, max(deadline - time.monotonic(), 0.0))
                if pause > 0:
                    time.sleep(pause)
                continue
            if resp.ok:
                return resp.value
            if resp.retryable:
                fut = router.rpc_register(rid)  # re-arm for the retry
                # same exponential schedule as the timeout branch: a
                # restarting worker can take tens of seconds to
                # register its node — constant 50ms pacing would hammer
                # it with hundreds of round trips
                pause = rng.uniform(0.5, 1.0) * min(
                    BACKOFF_FIRST * (2 ** (attempt - 1)), BACKOFF_CAP)
                time.sleep(min(pause,
                               max(deadline - time.monotonic(), 0.0)))
                continue
            if resp.error == "deadline_expired":
                break  # surfaces as RpcTimeout below
            router.rpc_note("rpc_remote_errors")
            raise RemoteError(
                f"rpc {op} on {node} failed remotely: {resp.error}")
    finally:
        router.rpc_forget(rid)
    state = router.rpc_peer_state(node) if \
        hasattr(router, "rpc_peer_state") else None
    if state in ("suspect", "down", "never-connected"):
        router.rpc_note("rpc_unreachable")
        raise Unreachable(
            f"node {node} is unreachable for {op} "
            f"(peer state: {state}, {attempt} attempts)")
    router.rpc_note("rpc_timeouts")
    raise RpcTimeout(
        f"rpc {op} to {node} timed out after {timeout:.1f}s "
        f"({attempt} attempts)")


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------




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


_DELIVER = FaultDecision()
_DROP = FaultDecision(action="drop")


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
        self._rngs: dict = {}
        self._spent: dict = {}       # stream key -> faults injected
        self._lock = threading.Lock()
        self.partitioned: set = set()
        #: injected-fault counters by kind (drop/delay/duplicate/
        #: reorder/partition), for the transport that consults the plan
        self.counters: dict = {}
        self.domains = dict(domains or {})
        self._local_domain = self.domains.get("local", "")
        #: peer name -> domain name (compiled from domains["members"])
        self._domain_of: dict = {
            peer: dname
            for dname, peers in self.domains.get("members", {}).items()
            for peer in peers}
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

    # -- decision -----------------------------------------------------------

    def _spec_for(self, peer: str, frame_class: str) -> FaultSpec:
        return self._resolve(peer, frame_class, "send")[0]

    def _domain_pair(self, peer: str, direction: str):
        """The (src, dst) matrix cell a frame to/from ``peer`` crosses,
        or None when the peer has no domain or no cell applies.  An
        exact key wins; the reversed pair covers the symmetric-RTT
        common case."""
        dom = self._domain_of.get(peer)
        if dom is None or not self._matrix:
            return None
        pair = (self._local_domain, dom) if direction == "send" \
            else (dom, self._local_domain)
        if pair in self._matrix:
            return pair
        rev = (pair[1], pair[0])
        return rev if rev in self._matrix else None

    def _resolve(self, peer: str, frame_class: str, direction: str):
        """(spec, domain_pair): domain_pair is the matrix cell the spec
        came from, None for explicitly keyed specs (which rank above the
        matrix) and the default (which ranks below)."""
        if (peer, frame_class) in self.by_peer_class:
            return self.by_peer_class[(peer, frame_class)], None
        if peer in self.by_peer:
            return self.by_peer[peer], None
        if frame_class in self.by_class:
            return self.by_class[frame_class], None
        pair = self._domain_pair(peer, direction)
        if pair is not None:
            return self._matrix[pair], pair
        return self.default, None

    def _note(self, kind: str, peer: str = "",
              frame_class: str = "") -> None:
        self.counters[kind] = self.counters.get(kind, 0) + 1
        record("net.fault", kind=kind, peer=peer, cls=frame_class)

    def is_partitioned(self, peer: str) -> bool:
        if peer in self.partitioned:
            self._note("partition", peer)
            return True
        return False

    def recv_peer(self, names) -> str:
        """Fault-stream key for an inbound connection whose hello named
        ``names``: the first name the plan explicitly targets (partition
        or per-peer spec), else the first name."""
        for n in names:
            if n in self.partitioned or n in self.by_peer or \
                    any(k[0] == n for k in self.by_peer_class):
                return n
        return names[0] if names else "?"

    #: every fault kind a call site may honor; paths that can only drop
    #: pass honor={"drop"}, so an unhonorable decision neither spends the
    #: spec's limit nor counts as injected
    ALL_FAULTS = frozenset({"drop", "delay", "duplicate", "reorder"})

    def decide(self, peer: str, frame_class: str,
               direction: str = "send",
               honor: frozenset = ALL_FAULTS) -> FaultDecision:
        """The fault for one frame, drawn from the seeded stream of
        ``(peer, frame_class, direction)``: one stream's draws never
        perturb another's, so a schedule replays whatever the thread
        interleaving."""
        if peer in self.partitioned:
            self._note("partition", peer, frame_class)
            return _DROP
        spec, domain_pair = self._resolve(peer, frame_class, direction)
        if spec.drop == spec.delay == spec.duplicate == spec.reorder == 0:
            return _DELIVER
        key = (peer, frame_class, direction)
        with self._lock:
            rng = self._rngs.get(key)
            if rng is None:
                rng = self._rngs[key] = random.Random(
                    f"{self.seed}:{peer}:{frame_class}:{direction}")
            if spec.limit and self._spent.get(key, 0) >= spec.limit:
                return _DELIVER
            roll = rng.random()
            edge = 0.0
            for kind, prob in (("drop", spec.drop),
                               ("delay", spec.delay),
                               ("duplicate", spec.duplicate),
                               ("reorder", spec.reorder)):
                edge += prob
                if roll >= edge:
                    continue
                if kind not in honor:
                    return _DELIVER
                self._spent[key] = self._spent.get(key, 0) + 1
                self._note(kind, peer, frame_class)
                if kind == "drop":
                    return _DROP
                if kind == "delay":
                    lo, hi = spec.delay_ms
                    delay_s = rng.uniform(lo, hi) / 1000.0
                    if domain_pair is not None:
                        # a matrix stretch is geography, not chaos:
                        # timelines name the domain crossing
                        record("rpc.domain_delay", peer=peer,
                               cls=frame_class, src=domain_pair[0],
                               dst=domain_pair[1],
                               delay_ms=round(delay_s * 1000.0, 3))
                    return FaultDecision(delay_s=delay_s)
                if kind == "duplicate":
                    return FaultDecision(duplicate=True)
                return FaultDecision(reorder=True)
        return _DELIVER

    def overview(self) -> dict:
        out = {"seed": self.seed,
               "partitioned": sorted(self.partitioned),
               "injected": dict(self.counters)}
        if self._matrix:
            out["local_domain"] = self._local_domain
            out["domain_matrix"] = sorted(
                f"{src}->{dst}" for src, dst in self._matrix)
        return out


def stamp_origin(req: RpcRequest, origin: tuple,
                 router_id: str) -> RpcRequest:
    """Fill the transport-owned origin fields just before the wire."""
    return replace(req, origin=tuple(origin), origin_router=router_id)
