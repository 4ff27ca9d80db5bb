"""The placement fabric: the supervisor's probe path and the host tier's
adoption verbs over the reliable control-plane RPC layer
(:mod:`ra_tpu_torch.transport.rpc`).  The port's copy of
``ra_tpu/placement/fabric.py``; in one process it rides a
``LocalRouter``.

* :class:`RpcEngineProbe`, the supervisor side: a probe callable that
  issues a ``host_status`` RPC on its own thread and returns **None**
  (asynchronous) at once; a completed round trip lands through
  :meth:`EngineSupervisor.probe_reply` stamped with the probe's issue
  time and the slot generation captured then.
* :class:`HostAgent`, the host side: the ``host_*`` verbs on a
  :class:`~ra_tpu_torch.node.RaNode`'s ``control_ops``, so they ride the
  reliable RPC plane (retries, deadlines, receiver-side dedup: a
  duplicated ``host_adopt`` adopts once).  Verbs that touch the serving
  stack run on the host's serving loop through a queue and an event
  (:meth:`HostAgent.pump`): an engine, plane or listener is
  single-threaded.

Every RPC call here carries an explicit ``timeout=``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ..blackbox import record
from ..transport.rpc import reliable_node_call
from .table import PlacementCache

__all__ = ["RpcEngineProbe", "HostAgent", "remote_adopt",
           "remote_lane_sums", "remote_rehome", "push_placement"]


class RpcEngineProbe:
    """An asynchronous heartbeat for one engine slot: each call starts at
    most one in-flight ``host_status`` RPC (paced by ``min_interval``)
    and returns None.  :meth:`bind` attaches the supervisor once it
    watches the slot."""

    def __init__(self, router, node: str, eid: str, *,
                 timeout: float = 2.0, min_interval: float = 0.05,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.router = router
        self.node = node
        self.eid = eid
        self.timeout = float(timeout)
        self.min_interval = float(min_interval)
        self._clock = clock
        self.sup = None
        self._in_flight = False
        self._last_issue = -float("inf")
        self._lock = threading.Lock()
        self.replies = 0
        self.failures = 0

    def bind(self, sup) -> None:
        self.sup = sup

    def __call__(self) -> None:
        now = self._clock()
        with self._lock:
            if self._in_flight or now - self._last_issue < self.min_interval:
                return None
            self._in_flight = True
            self._last_issue = now
        gen = self.sup.generation(self.eid) if self.sup is not None \
            else None
        threading.Thread(target=self._probe_once, args=(now, gen),
                         daemon=True, name=f"rpc-probe-{self.eid}").start()
        return None

    def _probe_once(self, issued_at: float, generation) -> None:
        try:
            res = reliable_node_call(self.router, self.node, "host_status",
                                     {"eid": self.eid},
                                     timeout=self.timeout)
            if isinstance(res, dict) and res.get("alive") and \
                    self.sup is not None:
                # heard at issue time: the RTT shows as age
                self.sup.probe_reply(self.eid, heard_at=issued_at,
                                     generation=generation)
                self.replies += 1
        except (RuntimeError, TimeoutError):
            self.failures += 1      # silence: the verdict ladder judges
        finally:
            with self._lock:
                self._in_flight = False


class HostAgent:
    """Serves one :class:`~ra_tpu_torch.placement.host.LaneEngineHost`
    over the node control plane; call :meth:`pump` from the host's
    serving loop every cycle."""

    #: bound every loop-bridged verb waits for the serving loop
    BRIDGE_TIMEOUT_S = 60.0

    def __init__(self, host, node, *, generation: int = 1,
                 placement_rid: Optional[str] = None) -> None:
        self.host = host
        self.node = node
        self.generation = int(generation)
        self.stopped = threading.Event()
        self._actions: queue.Queue = queue.Queue()
        #: the serving-path placement view: committed table state pushed
        #: here (``host_placement``); fail-open while empty
        self.cache = PlacementCache()
        self.placement_rid = placement_rid
        if placement_rid is not None:
            host.listener.bind_placement(self.cache, {host.engine_id},
                                         rids={placement_rid})
        node.control_ops.update({
            "host_status": self._op_status,
            "host_address": self._op_address,
            "host_adopt": self._op_adopt,
            "host_rehome": self._op_rehome,
            "host_placement": self._op_placement,
            "host_lane_sums": self._op_lane_sums,
            "host_stop": self._op_stop,
        })

    def pump(self) -> int:
        """Run the queued loop-bridged verbs; returns how many ran."""
        done = 0
        while True:
            try:
                fn, box, ev = self._actions.get_nowait()
            except queue.Empty:
                return done
            try:
                box["res"] = fn()
            except Exception as exc:  # noqa: BLE001 — travels to caller
                box["exc"] = exc
            ev.set()
            done += 1

    def _run_on_loop(self, fn: Callable[[], Any]) -> Any:
        box: dict = {}
        ev = threading.Event()
        self._actions.put((fn, box, ev))
        if not ev.wait(self.BRIDGE_TIMEOUT_S):
            raise TimeoutError("host serving loop did not pump the "
                               "bridged control verb within deadline")
        if "exc" in box:
            raise box["exc"]
        return box["res"]

    def _op_status(self, args: dict) -> dict:
        # answered at once (no bridge): the probe path never waits
        return {"eid": self.host.engine_id,
                "alive": bool(self.host.alive()),
                "generation": self.generation}

    def _op_address(self, args: dict) -> dict:
        eid = args.get("engine", self.host.engine_id)
        lst = self.host.listener if eid == self.host.engine_id \
            else self.host.adopted_listener(eid)
        addr = lst.address
        return {"engine": eid,
                "address": list(addr) if addr is not None else None}

    def _op_adopt(self, args: dict) -> dict:
        victim = args["victim"]

        def do():
            lst = self.host.adopt(victim, args["victim_dir"],
                                  trace_ctx=args.get("trace_ctx"))
            if args.get("rid") is not None:
                # the adopted range's new home is this host's engine
                lst.bind_placement(self.cache, {self.host.engine_id},
                                   rids={args["rid"]})
            return lst.address
        addr = self._run_on_loop(do)
        record("placement.adopt_rpc", victim=victim,
               survivor=self.host.engine_id,
               address=str(addr) if addr else "loopback")
        return {"victim": victim, "survivor": self.host.engine_id,
                "address": list(addr) if addr is not None else None}

    def _op_rehome(self, args: dict) -> dict:
        """Pre-claim a re-homed client's session block on the adopted
        listener (old dedup slots, watermarks at the acked counts);
        returns the recovered durable op-id watermarks."""
        victim = args["victim"]

        def do():
            return self.host.adopted_listener(victim).claim_sessions(
                args["key"], int(args["n_sessions"]),
                slots=np.asarray(args["slots"], np.int64),
                committed=np.asarray(args["committed"], np.int64),
                tenants=int(args.get("tenants", 1)),
                trace_ctx=args.get("trace_ctx")).tolist()
        return {"victim": victim, "durable": self._run_on_loop(do)}

    def _op_placement(self, args: dict) -> dict:
        """Adopt a pushed table snapshot (revision-monotone)."""
        def do():
            changed = self.cache.refresh(args["state"])
            return {"rev": int(self.cache.rev), "changed": bool(changed)}
        return self._run_on_loop(do)

    def _op_lane_sums(self, args: dict) -> dict:
        eid = args.get("engine", self.host.engine_id)

        def do():
            eng = self.host.engine if eid == self.host.engine_id \
                else self.host.adopted_engine(eid)
            vals = eng.consistent_read(np.arange(self.host.lanes))["value"]
            return np.asarray(vals).astype(np.int64).tolist()
        return {"engine": eid, "sums": self._run_on_loop(do)}

    def _op_stop(self, args: dict) -> str:
        self.stopped.set()
        return "stopping"


def remote_adopt(router, node: str, victim: str, victim_dir: str, *,
                 survivor: str, rid: Optional[str] = None,
                 timeout: float = 30.0, trace_ctx: Optional[str] = None):
    """Adopt ``victim`` on a remote survivor host; returns the adopted
    listener's ``(host, port)``, or None for loopback."""
    res = reliable_node_call(router, node, "host_adopt",
                             {"victim": victim, "victim_dir": victim_dir,
                              "survivor": survivor, "rid": rid,
                              "trace_ctx": trace_ctx},
                             timeout=timeout, trace_ctx=trace_ctx)
    addr = res.get("address") if isinstance(res, dict) else None
    return tuple(addr) if addr is not None else None


def remote_rehome(router, node: str, victim: str, client, *,
                  timeout: float = 30.0, trace_ctx: Optional[str] = None):
    """Pre-claim ``client``'s session block on the survivor's adopted
    listener; the durable op-id watermarks for ``WireClient.rehome_to``."""
    res = reliable_node_call(
        router, node, "host_rehome",
        {"victim": victim, "key": client.key,
         "n_sessions": client.n_sessions,
         "slots": np.asarray(client.slots, np.int64).tolist(),
         "committed": client.watermark.tolist(),
         "tenants": client.tenants, "trace_ctx": trace_ctx},
        timeout=timeout, trace_ctx=trace_ctx)
    return np.asarray(res["durable"], np.int64)


def push_placement(router, node: str, state: dict, *,
                   timeout: float = 10.0) -> dict:
    """Push a committed table snapshot to one host's cache."""
    return reliable_node_call(router, node, "host_placement",
                              {"state": state}, timeout=timeout)


def remote_lane_sums(router, node: str, engine: str, *,
                     timeout: float = 30.0) -> np.ndarray:
    """The per-lane machine sums a host serves for ``engine`` (its own
    id or an adopted victim's): the oracle's remote read."""
    res = reliable_node_call(router, node, "host_lane_sums",
                             {"engine": engine}, timeout=timeout)
    return np.asarray(res["sums"], np.int64)
