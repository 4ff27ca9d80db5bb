"""Node runtime: the effect-executing shell around pure cores (the
port's own copy of ``ra_tpu/node.py``).

The reference runs one gen_statem per member (ra_server_proc.erl) under a
per-system supervision tree (ra_system_sup.erl:25-43).  This runtime's
inversion keeps *control flow on the host, state in cores*: a RaNode is a
single event-loop thread cooperatively scheduling all member shells it
hosts — the natural collector that forms device batches for the lane
engine, and the 'node' unit for the classic (oracle) deployment.

Responsibilities mirrored from ra_server_proc.erl:
* effect execution (send_rpc, vote fan-out, replies, timers, machine
  effects — handle_effect :1317-1566)
* election timers with randomized durations (:1638-1657)
* periodic tick (ra_server:tick + machine tick)
* snapshot send tasks (:1446-1488) — chunked InstallSnapshotRpc casts
* monitors/down routing (simplified; full failure detector in transport)
* registration in the node directory + leaderboard updates

Transport is pluggable: LocalRouter routes in-process between RaNodes
(the ct_slave-style multi-node tests run this way);
``transport/tcp.py``'s ``TcpRouter`` carries the same six message families
across OS processes.
"""
from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Optional

from .blackbox import RECORDER, record
from .core.server import RaServer
from .core.types import (
    AuxCommandEvent,
    AuxEffect,
    CancelElectionTimeout,
    Checkpoint,
    CommandEvent,
    CommandsEvent,
    ConsistentQueryEvent,
    Demonitor,
    ElectionTimeout,
    ErrorResult,
    GarbageCollection,
    InstallSnapshotRpc,
    LogReadEffect,
    ModCall,
    Monitor,
    NODE_SCOPE,
    NodeControlEvent,
    Notify,
    Priority,
    PromoteCheckpoint,
    RaftState,
    RecordLeader,
    ReleaseCursor,
    SNAPSHOT_TUNABLE_KEYS,
    Reply,
    ReplyMode,
    SendMsg,
    SendRpc,
    SendSnapshot,
    SendVoteRequests,
    ServerConfig,
    ServerId,
    StartElectionTimeout,
    TickEvent,
    TimerEffect,
    UserCommand,
)
from .log.memory import MemoryLog
from .log.wal import WalDown

logger = logging.getLogger("ra_tpu_torch")

#: multipliers applied to election_timeout_ms per timeout kind
#: (ra_server_proc.erl:1638-1657: really_short/short/medium/long)
_TIMEOUT_KINDS = {
    "really_short": (0.05, 0.15),
    "short": (0.3, 0.6),
    "medium": (1.0, 1.6),
    "long": (2.0, 3.2),
}

#: low-priority commands buffered before a {commands, ...} flush — the
#: reference's ?FLUSH_COMMANDS_SIZE (ra_server.hrl:11) default; the
#: per-server ``ServerConfig.command_flush_size`` knob overrides it
#: (the batch-native append path amortizes one lock + one
#: WAL fan-in submit over the whole flush, so deeper flushes are
#: strictly cheaper until the AER frame bounds bite)
FLUSH_COMMANDS_SIZE = 16


class Future:
    """Reply slot handed to blocking client calls."""

    __slots__ = ("_event", "value")

    def __init__(self) -> None:
        self._event = threading.Event()
        self.value: Any = None

    def set(self, value: Any) -> None:
        self.value = value
        self._event.set()

    def wait(self, timeout: Optional[float]) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("ra: command timed out")
        return self.value


class LocalRouter:
    """In-process transport fabric: ServerId.node -> RaNode."""

    def __init__(self) -> None:
        self.nodes: dict[str, "RaNode"] = {}
        self.lock = threading.Lock()
        # (src_node, dst_node) pairs currently blocked (nemesis partitions)
        self.blocked: set = set()

    def register(self, node: "RaNode") -> None:
        with self.lock:
            self.nodes[node.name] = node

    def unregister(self, node: "RaNode") -> None:
        with self.lock:
            self.nodes.pop(node.name, None)

    def send(self, src_node: str, to: ServerId, msg: Any) -> bool:
        """Nonblocking send; returns False when dropped (the noconnect/
        nosuspend semantics of ra_server_proc:send_rpc :1317-1341)."""
        if (src_node, to.node) in self.blocked:
            return False
        node = self.nodes.get(to.node)
        if node is None:
            return False
        return node.deliver(to, msg)

    def block(self, a: str, b: str) -> None:
        self.blocked.add((a, b))
        self.blocked.add((b, a))

    def heal(self) -> None:
        self.blocked.clear()

    def remote_call(self, target: ServerId, make_event) -> Optional["Future"]:
        """Cross-host client call; the in-process router has no remote
        reach (TcpRouter overrides)."""
        return None

    def reply_remote(self, handle: tuple, msg: Any) -> None:
        """Route a reply for a remote call handle (TcpRouter overrides)."""
        return None

    def notify_remote(self, handle: tuple, correlations: Any) -> None:
        """Route an applied-notification for a remote-notify handle
        (TcpRouter overrides)."""
        return None


#: default in-process fabric (tests may build private ones)
DEFAULT_ROUTER = LocalRouter()


class ServerShell:
    """Per-member shell state owned by a RaNode."""

    def __init__(self, server: RaServer, node: "RaNode") -> None:
        self.server = server
        self.node = node
        self.inbox: deque = deque()
        self.low_queue: deque = deque()  # low-priority commands awaiting flush
        # pids the machine/aux asked to monitor, by component
        # (ra_monitors.erl per-component multiplexing)
        self.machine_monitors: set = set()
        self.aux_monitors: set = set()
        #: machine {timer, Name, T} effects: name -> (deadline, msg)
        #: (ra_server_proc.erl:1549-1550; expiry appends a '{timeout,
        #: Name}' command on the leader, :556-560)
        self.machine_timers: dict = {}
        self.election_deadline: Optional[float] = None
        self.tick_deadline: float = time.monotonic() + \
            server.cfg.tick_interval_ms / 1000.0
        #: per-shell flush depth (ServerConfig.command_flush_size,
        #: falling back to the reference's 16) — cached here so the
        #: poll loop pays one attribute read, not a config chain
        self.flush_size = getattr(server.cfg, "command_flush_size", 0) \
            or FLUSH_COMMANDS_SIZE
        self.stopped = False

    @property
    def sid(self) -> ServerId:
        return self.server.id


class RaNode:
    """One 'node': hosts many cluster members on one event-loop thread."""

    def __init__(self, name: str, router: Optional[LocalRouter] = None,
                 log_factory: Optional[Callable] = None,
                 system: Any = None, device: Any = None) -> None:
        """``device`` goes into every hosted machine's init config: a
        JitMachine keeps its replica state there (None: the CUDA card;
        the CPU only as ``"cpu"``); a host Machine ignores it."""
        self.name = name
        self.device = device
        self.router = router or DEFAULT_ROUTER
        #: owning RaSystem (optional): enables control-plane recovery of
        #: members from the on-disk directory (recover_config role)
        self.system = system
        if log_factory is None and system is not None:
            log_factory = system.log_factory
        self.log_factory = log_factory or (lambda cfg: MemoryLog())
        from .metrics import Counters, Leaderboard
        self.counters = Counters()
        self.leaderboard_tab = Leaderboard()
        self.shells: dict[str, ServerShell] = {}   # by server name
        self.directory: dict[str, ServerConfig] = {}  # uid -> config
        self.leaderboard: dict[str, tuple] = {}    # cluster -> (leader, members)
        self._crash_times: dict[str, list] = {}    # supervised restarts
        #: pluggable control verbs: op name -> fn(args) ->
        #: result, consulted before the unknown-op fallback.  The
        #: cross-host placement fabric registers its engine-host verbs
        #: (host_status/host_adopt/...) here so they ride the SAME
        #: reliable-RPC control plane as the builtin lifecycle ops —
        #: dedup cache, deadline propagation and all.
        self.control_ops: dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ra-node-{name}")
        self.router.register(self)
        self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def start_server(self, config: ServerConfig) -> ServerId:
        """Init + recover a member on this node (ra:start_server)."""
        assert config.server_id.node == self.name
        log = self.log_factory(config)
        server = RaServer(config, log,
                          machine_config={"device": self.device})
        server.recover()
        shell = ServerShell(server, self)
        self.counters.new(config.uid)
        with self._lock:
            self.shells[config.server_id.name] = shell
            self.directory[config.uid] = config
        # new servers get an election timeout so a fresh cluster elects
        self._arm_election(shell, "medium")
        # co-hosted siblings learn the member is back: a leader that saw
        # the kill's DownEvent resumes replication (the up edge the
        # transport detector provides for cross-node peers — without it
        # a restarted behind-the-tail follower wedges)
        self._notify_up(config.server_id)
        self._wake.set()
        return config.server_id

    def stop_server(self, name: str) -> None:
        # NB: the log is NOT closed here — it is owned by its factory/system
        # and survives server restarts (storage identity vs process
        # identity, ra_log_wal.erl:44-51)
        with self._lock:
            shell = self.shells.pop(name, None)
        if shell is not None:
            shell.stopped = True
            # clean stop: persist the lazy apply watermark so recovery
            # dedups every effect the subscriber already saw (a kill
            # keeps the crash semantics — see kill_server)
            try:
                shell.server.flush_applied_watermark()
            except Exception:  # noqa: BLE001 — a closed log must not block stop
                logger.exception("ra_tpu_torch node %s: apply-watermark flush "
                                 "on stop of %s failed", self.name, name)

    #: supervised-restart intensity: allow this many crashes within the
    #: period before giving up (the ra_server_sup transient strategy —
    #: intensity 2, period 5s; ra_server_sup.erl)
    RESTART_INTENSITY = 2
    RESTART_PERIOD_S = 5.0

    def _maybe_restart(self, sid: ServerId) -> bool:
        """Supervised restart of a crashed member over its surviving log
        (storage identity outlives the process, ra_log_wal.erl:44-51).
        Returns False once the crash intensity is exceeded — the member
        stays down and peers get the DOWN signal, exactly like an OTP
        supervisor giving up on a child."""
        now = time.monotonic()
        times = self._crash_times.setdefault(sid.name, [])
        times[:] = [t for t in times if now - t < self.RESTART_PERIOD_S]
        times.append(now)
        if len(times) > self.RESTART_INTENSITY:
            logger.error(
                "ra_tpu_torch node %s: server %s exceeded restart intensity "
                "(%d in %.0fs); giving up", self.name, sid,
                self.RESTART_INTENSITY, self.RESTART_PERIOD_S)
            record("sup.giveup", plane="server", node=self.name,
                   server=str(sid))
            RECORDER.dump(
                "server_restart_giveup",
                what=f"server crash intensity exceeded "
                     f"({self.RESTART_INTENSITY} in "
                     f"{self.RESTART_PERIOD_S:.0f}s)",
                where=str(sid),
                data_dir=getattr(self.system, "data_dir", None))
            return False
        cfg = self._config_for(sid.name)
        if cfg is None:
            return False
        # only restart over a log with DURABLE identity: a fresh
        # in-memory log forgets term/voted_for, and a restarted member
        # could then double-vote in a term it already voted in (the
        # amnesia hazard forget_server documents)
        probe = self.log_factory(cfg)
        if not getattr(probe, "durable", False):
            logger.warning(
                "ra_tpu_torch node %s: not auto-restarting %s — its log "
                "factory has no durable identity", self.name, sid)
            return False
        try:
            self.start_server(cfg)
        except Exception:
            logger.exception("ra_tpu_torch node %s: restart of %s failed",
                             self.name, sid)
            return False
        logger.warning("ra_tpu_torch node %s: server %s restarted after crash",
                       self.name, sid)
        record("sup.restart", plane="server", node=self.name,
               server=str(sid))
        return True

    def _config_for(self, name: str):
        with self._lock:
            cfg = None
            for c in self.directory.values():
                if c.server_id.name == name:
                    cfg = c
            return cfg

    #: config keys a restart may modify — the reference's
    #: ?MUTABLE_CONFIG_KEYS whitelist (ra_server_sup_sup.erl:12-20);
    #: identity/consensus-bearing keys (uid, members, machine,
    #: election timeout) are immutable across restarts
    MUTABLE_CONFIG_KEYS = frozenset({
        "cluster_name", "broadcast_time_ms", "tick_interval_ms",
        "install_snap_rpc_timeout_ms", "await_condition_timeout_ms",
        "max_pipeline_count", "friendly_name",
    })

    def _merge_mutable(self, cfg: ServerConfig,
                       mutable: Optional[dict]) -> ServerConfig:
        if not mutable:
            return cfg
        from dataclasses import replace as _dc_replace
        accepted = {k: v for k, v in mutable.items()
                    if k in self.MUTABLE_CONFIG_KEYS}
        dropped = set(mutable) - set(accepted)
        if dropped:
            logger.warning("ra_tpu_torch node %s: restart config keys %s are "
                           "not mutable; ignored", self.name,
                           sorted(dropped))
        return _dc_replace(cfg, **accepted) if accepted else cfg

    def restart_server(self, name: str,
                       mutable: Optional[dict] = None) -> ServerId:
        """Restart from the persisted log (ra:restart_server, §3.4).
        ``mutable`` merges whitelisted config keys into the recovered
        config (config_modification_at_restart, ra_server_sup_sup.erl:
        80-103).  Falls back to the system directory's persisted
        snapshot when the in-memory config is gone (node process
        restarted) — the same recover_config path the control plane
        takes."""
        cfg = self._config_for(name)
        if cfg is None:
            snap = self._disk_snapshot_for(name)
            if snap is None:
                raise RuntimeError(f"restart_server: unknown server "
                                   f"{name} (not_found)")
            cfg = self._config_from_snapshot(snap)
        cfg = self._merge_mutable(cfg, mutable)
        self.stop_server(name)
        return self.start_server(cfg)

    def kill_server(self, name: str) -> None:
        """Abrupt stop without log close (crash simulation)."""
        with self._lock:
            shell = self.shells.pop(name, None)
        if shell is not None:
            shell.stopped = True
            self._notify_down(shell.sid)

    def forget_server(self, name: str) -> None:
        """Drop a member's config from the node directory so
        restart_server can no longer recreate it — the node-side half of
        force_delete (a deleted member resurrected over an empty log
        would rejoin with amnesia under its old identity and could vote
        unsafely)."""
        with self._lock:
            for uid, c in list(self.directory.items()):
                if c.server_id.name == name:
                    del self.directory[uid]

    def _notify_down(self, dead: ServerId) -> None:
        """Local process-monitor role (ra_monitors): co-hosted members
        learn immediately that a sibling died — followers of a dead leader
        arm a really_short election (ra_server_proc.erl:760-788)."""
        from .core.types import DownEvent
        for other in list(self.shells.values()):
            if not other.stopped:
                other.inbox.append(DownEvent(dead))
        self._wake.set()

    def _notify_up(self, sid: ServerId) -> None:
        """The restart twin of _notify_down: co-hosted siblings (most
        importantly a leader that marked this peer DISCONNECTED at the
        kill's DownEvent) resume treating it as reachable."""
        from .core.types import UpEvent
        for other in list(self.shells.values()):
            if not other.stopped and other.sid != sid:
                other.inbox.append(UpEvent(sid))

    def process_down(self, pid: Any, reason: Any = "normal") -> None:
        """Report death of a machine-monitored external process.  Members
        monitoring ``pid`` get a ``("down", pid, reason)`` builtin command
        (ra_server:handle_down machine branch).  In practice only the
        current leader holds machine monitors — followers filter machine
        Monitor effects and a demoted leader clears its set — so exactly
        one member appends the command."""
        for shell in list(self.shells.values()):
            if shell.stopped:
                continue
            if pid in shell.machine_monitors:
                shell.machine_monitors.discard(pid)
                shell.inbox.append(CommandEvent(
                    UserCommand(("down", pid, reason)), from_=None))
            if pid in shell.aux_monitors:
                # aux branch of handle_down (ra_server.erl): the aux
                # handler sees the down directly, no log entry.  Routed
                # through the inbox so the (unsynchronized) RaServer is
                # only ever touched by the event-loop thread.
                shell.aux_monitors.discard(pid)
                shell.inbox.append(AuxCommandEvent(("down", pid, reason)))
        self._wake.set()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        # clean node shutdown: persist every live server's lazy apply
        # watermark (the event loop is joined, nothing applies anymore)
        for shell in list(self.shells.values()):
            try:
                shell.server.flush_applied_watermark()
            except Exception:  # noqa: BLE001 — a closed log must not block stop
                logger.exception("ra_tpu_torch node %s: apply-watermark flush "
                                 "on node stop failed", self.name)
        self.router.unregister(self)

    # -- ingress ------------------------------------------------------------

    def deliver(self, to: ServerId, msg: Any) -> bool:
        if to.name == NODE_SCOPE:
            # node-lifecycle RPC (ra_server_sup_sup's rpc:call target):
            # runs on its own thread — start/restart recover logs and
            # must never block the transport's recv loop
            if not isinstance(msg, NodeControlEvent):
                return False
            threading.Thread(target=self._handle_control, args=(msg,),
                             daemon=True,
                             name=f"ra-node-ctrl-{self.name}").start()
            return True
        shell = self.shells.get(to.name)
        if shell is None or shell.stopped:
            return False
        shell.inbox.append(msg)
        if not self._wake.is_set():  # see submit_command
            self._wake.set()
        return True

    # -- control plane (cross-node lifecycle, ra_server_sup_sup.erl:42-130)

    def _handle_control(self, event: NodeControlEvent) -> None:
        from .core.types import ErrorResult
        op, args = event.op, dict(event.args)
        try:
            if op == "ping":
                result: Any = ("pong", self.name)
            elif op == "start_server":
                result = self._control_start(args)
            elif op == "restart_server":
                result = self._control_restart(args)
            elif op == "stop_server":
                self.stop_server(args["name"])
                result = "ok"
            elif op == "force_delete_server":
                result = self._control_force_delete(args)
            elif op == "classic_stats":
                # read-only batching-health probe: lets a
                # bench/ops client collect the leader's CLASSIC_FIELDS
                # from a remote worker process over the control plane
                result = self.classic_stats()
            elif op in self.control_ops:
                result = self.control_ops[op](args)
            else:
                result = ErrorResult(f"unknown_control_op:{op}", None)
        except Exception as exc:  # noqa: BLE001 — errors travel to caller
            logger.exception("ra_tpu_torch node %s: control op %s failed",
                             self.name, op)
            result = ErrorResult(f"control_failed: {exc!r}"[:400], None)
        to = event.from_
        if to is None:
            return
        if isinstance(to, Future):
            to.set(result)
        elif isinstance(to, tuple) and to and to[0] == "rcall":
            self.router.reply_remote(to, result)
        elif callable(to):
            to(result)

    def _control_start(self, args: dict) -> Any:
        """start_server_rpc (ra_server_sup_sup.erl:56-77): build the
        member from a picklable config snapshot + machine spec.  A name
        that is RUNNING is already_started; a name with existing durable
        (or node-directory) state is not_new — recreating it under a
        fresh uid would orphan its log and rejoin it with amnesia (the
        double-vote hazard forget_server documents); the caller wants
        restart_server."""
        from .core.types import ErrorResult
        cfg = self._config_from_snapshot(args["config"])
        name = cfg.server_id.name
        shell = self.shells.get(name)
        if shell is not None and not shell.stopped:
            return ErrorResult("already_started", None)
        if self._config_for(name) is not None or \
                (self.system is not None and
                 self.system.directory.where_is(name) is not None):
            return ErrorResult("not_new", None)
        return self.start_server(cfg)

    def _control_restart(self, args: dict) -> Any:
        """restart_server_rpc: prefer the in-memory config; fall back to
        the system directory's persisted snapshot (recover_config,
        ra_server_sup_sup.erl:80-103)."""
        from .core.types import ErrorResult
        try:
            return self.restart_server(args["name"],
                                       mutable=args.get("mutable"))
        except RuntimeError:
            return ErrorResult("not_found", None)

    def _control_force_delete(self, args: dict) -> Any:
        name = args["name"]
        shell = self.shells.get(name)
        uid = shell.server.cfg.uid if shell is not None else None
        if uid is None and self.system is not None:
            uid = self.system.directory.where_is(name)
        self.kill_server(name)
        self.forget_server(name)
        self.wipe_member_footprint(uid, self.system)
        return "ok"

    @staticmethod
    def wipe_member_footprint(uid, system) -> None:
        """The force-delete footprint wipe shared by the control plane
        and the api layer: durable data via ``system`` when present
        (delete_server_data also drops the uid-scoped machine_ets side
        tables), else the side tables alone — a deleted member must
        leave nothing behind either way."""
        if uid is None:
            return
        if system is not None:
            system.delete_server_data(uid)
        else:
            from . import machine_ets
            machine_ets.drop_scope(uid)

    def _disk_snapshot_for(self, name: str) -> Optional[dict]:
        if self.system is None:
            return None
        directory = self.system.directory
        uid = directory.where_is(name)
        if uid is None:
            return None
        snap = dict(directory.config_of(uid) or {})
        if not snap:
            return None
        snap.setdefault("uid", uid)
        return snap

    def _config_from_snapshot(self, snap: dict) -> ServerConfig:
        from .core.types import Membership
        from .machines import resolve_machine
        machine = resolve_machine(snap["machine_spec"])
        return ServerConfig(
            server_id=ServerId(*snap["server_id"]),
            uid=snap["uid"],
            cluster_name=snap["cluster_name"],
            initial_members=tuple(ServerId(*m)
                                  for m in snap["initial_members"]),
            machine=machine,
            election_timeout_ms=snap.get("election_timeout_ms", 100),
            tick_interval_ms=snap.get("tick_interval_ms", 100),
            broadcast_time_ms=snap.get("broadcast_time_ms", 50),
            membership=Membership(snap.get("membership", "voter")),
            system_name=snap.get("system_name", "default"),
            **{k: snap[k] for k in SNAPSHOT_TUNABLE_KEYS
               if k in snap},
        )

    def submit(self, name: str, event: Any) -> bool:
        shell = self.shells.get(name)
        if shell is None or shell.stopped:
            return False
        shell.inbox.append(event)
        self._wake.set()
        return True

    def submit_command(self, name: str, command: Any, from_: Any,
                       priority: Priority = Priority.NORMAL) -> bool:
        """Normal commands go straight in; low-priority commands buffer and
        flush as {commands, Batch} (ra_server_proc.erl:458-513)."""
        shell = self.shells.get(name)
        if shell is None or shell.stopped:
            return False
        if priority == Priority.LOW:
            # client threads only append; batches are formed exclusively by
            # the event-loop thread (_poll_shell) so the deque is never
            # iterated concurrently with appends
            shell.low_queue.append(command)
        else:
            shell.inbox.append(CommandEvent(command, from_=from_))
        # set-when-clear guard: at pipelined rates the flag is almost
        # always already set (the loop only clears it when idle), and
        # Event.set() takes a lock this path should not pay per command
        if not self._wake.is_set():
            self._wake.set()
        return True

    def submit_commands(self, name: str, commands: list,
                        priority: Priority = Priority.LOW) -> bool:
        """Burst submit: one queue extend + one wake check for the whole
        batch instead of a per-command submit_command round."""
        shell = self.shells.get(name)
        if shell is None or shell.stopped:
            return False
        if priority == Priority.LOW:
            shell.low_queue.extend(commands)
        else:
            shell.inbox.extend(CommandEvent(c, from_=None)
                               for c in commands)
        if not self._wake.is_set():
            self._wake.set()
        return True

    # -- event loop ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop:
            busy = False
            now = time.monotonic()
            for shell in list(self.shells.values()):
                if shell.stopped:
                    continue
                try:
                    busy |= self._poll_shell(shell, now)
                except WalDown:
                    # infra fault, not a server fault: park the core in
                    # await_condition(wal_down) and keep the shell alive —
                    # the system's WAL supervisor restarts the WAL and the
                    # log surfaces a WalUpEvent to resume
                    # (ra_server.erl:538-554)
                    logger.warning(
                        "ra_tpu_torch node %s: wal down; server %s parked",
                        self.name, shell.sid)
                    self._execute(shell, shell.server.enter_wal_down())
                    busy = True
                except Exception as exc:
                    logger.exception("ra_tpu_torch node %s: server %s crashed",
                                     self.name, shell.sid)
                    # unhandled server crash: a black-box trigger — the
                    # bundle captures what the whole node was doing at
                    # the moment this core died
                    record("srv.crash", node=self.name,
                           server=str(shell.sid), error=repr(exc)[:200])
                    RECORDER.dump(
                        "server_crash", what=repr(exc)[:200],
                        where=str(shell.sid),
                        data_dir=getattr(self.system, "data_dir", None))
                    shell.stopped = True
                    # remove so clients get fast noproc instead of
                    # blocking on a dead inbox / stale leader state
                    with self._lock:
                        self.shells.pop(shell.sid.name, None)
                    # peers always learn about the dead incarnation
                    # (monitors fire even when a supervisor restarts
                    # the child, ra_server_proc.erl:760-788)
                    self._notify_down(shell.sid)
                    if self._maybe_restart(shell.sid):
                        busy = True
            if not busy:
                self._wake.wait(timeout=0.005)
                self._wake.clear()

    def _poll_shell(self, shell: ServerShell, now: float) -> bool:
        busy = False
        # async WAL confirms arrive independently of inbox traffic; route
        # through _handle so terminal states are honored
        for evt in shell.server.log.take_events():
            self._handle(shell, evt)
            busy = True
            if shell.stopped:
                return busy
        # timers
        if shell.election_deadline is not None and \
                now >= shell.election_deadline:
            shell.election_deadline = None
            self._handle(shell, ElectionTimeout())
            busy = True
        # machine timers: on expiry the LEADER routes a '{timeout, Name}'
        # command through consensus so every replica's machine sees it
        # (ra_server_proc.erl:556-560); non-leaders drop the expiry — the
        # lane leader owns machine time
        if shell.machine_timers:
            due = [n for n, (dl, _m) in shell.machine_timers.items()
                   if now >= dl]
            for name in due:
                _dl, msg = shell.machine_timers.pop(name)
                if shell.server.raft_state == RaftState.LEADER:
                    data = msg if msg is not None else ("timeout", name)
                    self._handle(shell, CommandEvent(
                        UserCommand(data, reply_mode=ReplyMode.NOREPLY)))
                    busy = True
        if now >= shell.tick_deadline:
            shell.tick_deadline = now + \
                shell.server.cfg.tick_interval_ms / 1000.0
            self._handle(shell, TickEvent())
            busy = True
        # flush low-priority commands in batches of FLUSH_COMMANDS_SIZE
        # (ra_server_proc.erl:458-513); only this thread removes items.
        # The reference drains the whole backlog 16 at a time via a
        # flush_commands self-message loop interleaved with the mailbox
        # — mirror that by forming several batches per poll (bounded so
        # RPC/confirm traffic still interleaves); one batch per poll
        # under-drains deep pipelines (measured 1.4x classic-bench
        # throughput moving 1 -> 16 batches per poll)
        batches = 0
        while shell.low_queue and batches < 16:
            n = min(len(shell.low_queue), shell.flush_size)
            batch = tuple(shell.low_queue.popleft() for _ in range(n))
            shell.inbox.append(CommandsEvent(batch))
            batches += 1
        # messages (bounded batch per poll to stay fair)
        for _ in range(256):
            if not shell.inbox:
                break
            self._handle(shell, shell.inbox.popleft())
            busy = True
        return busy

    def _handle(self, shell: ServerShell, event: Any) -> None:
        server = shell.server
        c = self.counters
        key = server.cfg.uid
        c.incr(key, "msgs_processed")
        if isinstance(event, CommandEvent):
            c.incr(key, "commands")
        elif isinstance(event, CommandsEvent):
            c.incr(key, "command_flushes")
            c.incr(key, "commands", len(event.commands))
        elif isinstance(event, ConsistentQueryEvent):
            c.incr(key, "consistent_queries")
        else:
            from .core.types import (AppendEntriesReply, AppendEntriesRpc,
                                     AuxCommandEvent)
            if isinstance(event, AppendEntriesRpc):
                c.incr(key, "aer_received_follower")
                if not event.entries:
                    c.incr(key, "aer_received_follower_empty")
            elif isinstance(event, AppendEntriesReply):
                c.incr(key, "aer_replies_success" if event.success
                       else "aer_replies_fail")
            elif isinstance(event, AuxCommandEvent):
                c.incr(key, "aux_commands")
        state_before = server.raft_state
        effects = server.handle(event)
        state_after = server.raft_state
        if state_after != state_before:
            if state_before == RaftState.LEADER:
                # machine monitors are a leader responsibility; the new
                # leader re-establishes them via state_enter(leader), and a
                # stale set here would make this ex-leader relay duplicate
                # ('down', ...) commands
                shell.machine_monitors.clear()
            if state_after == RaftState.PRE_VOTE:
                c.incr(key, "pre_vote_elections")
            elif state_after == RaftState.CANDIDATE:
                c.incr(key, "elections")
            # NB: no snapshot_installed increment here — that field is
            # LOG_FIELDS, owned and counted by the log facade on actual
            # container install; an incr against this SERVER_FIELDS
            # group was silently dropped before telemetry_dropped
            # existed and would now (correctly) flag the mismatch
        self._execute(shell, effects)
        # drain WAL confirms produced by this event
        for evt in server.log.take_events():
            self._execute(shell, server.handle(evt))
        if server.raft_state in (RaftState.STOP,
                                 RaftState.DELETE_AND_TERMINATE):
            # terminal states: leave the cluster / cluster deleted
            # (ra_server_proc terminating_leader/_follower)
            shell.stopped = True
            with self._lock:
                self.shells.pop(shell.sid.name, None)

    # -- effect executor (ra_server_proc:handle_effect :1317-1566) ----------

    def _execute(self, shell: ServerShell, effects: list) -> None:
        server = shell.server
        for eff in effects:
            if isinstance(eff, SendRpc):
                self.counters.incr(server.cfg.uid, "rpcs_sent")
                self.counters.incr(server.cfg.uid, "msgs_sent")
                ok = self.router.send(self.name, eff.to, eff.msg)
                if not ok:
                    # dropped send: pipeline catch-up recovers; counted
                    # like the reference (ra.hrl:329-330)
                    self.counters.incr(server.cfg.uid, "dropped_sends")
            elif isinstance(eff, SendVoteRequests):
                n = len(eff.requests)
                self.counters.incr(server.cfg.uid, "rpcs_sent", n)
                self.counters.incr(server.cfg.uid, "msgs_sent", n)
                for to, msg in eff.requests:
                    self.router.send(self.name, to, msg)
            elif isinstance(eff, Reply):
                # member-replier replies execute ONLY on the named
                # member; everyone else (including the leader) skips —
                # can_execute_locally (ra_server_proc.erl)
                rep = getattr(eff, "replier", "leader")
                if rep != "leader" and not (
                        isinstance(rep, tuple) and len(rep) == 2 and
                        rep[0] == "member" and rep[1] == server.id):
                    continue
                if isinstance(eff.to, Future):
                    eff.to.set(eff.msg)
                elif isinstance(eff.to, tuple) and eff.to and \
                        eff.to[0] == "rcall":
                    self.router.reply_remote(eff.to, eff.msg)
                elif callable(eff.to):
                    eff.to(eff.msg)
            elif isinstance(eff, Notify):
                if isinstance(eff.to, Future):
                    eff.to.set(eff.correlations)
                elif isinstance(eff.to, tuple) and eff.to and \
                        eff.to[0] == "rnotify":
                    self.router.notify_remote(eff.to, eff.correlations)
                elif callable(eff.to):
                    eff.to(eff.correlations)
            elif isinstance(eff, StartElectionTimeout):
                self._arm_election(shell, eff.kind)
            elif isinstance(eff, CancelElectionTimeout):
                shell.election_deadline = None
            elif isinstance(eff, (ReleaseCursor, Checkpoint,
                                  PromoteCheckpoint)):
                if isinstance(eff, ReleaseCursor):
                    self.counters.incr(server.cfg.uid, "release_cursors")
                elif isinstance(eff, Checkpoint):
                    self.counters.incr(server.cfg.uid, "checkpoints")
                self._execute(shell, server.handle_machine_effect(eff))
            elif isinstance(eff, SendSnapshot):
                self._send_snapshot(shell, eff)
            elif isinstance(eff, RecordLeader):
                self.leaderboard[eff.cluster_name] = (eff.leader, eff.members)
                self.leaderboard_tab.record(eff.cluster_name, eff.leader,
                                            eff.members)
            elif isinstance(eff, SendMsg):
                self.counters.incr(server.cfg.uid, "send_msg_effects_sent")
                if isinstance(eff.to, Future):
                    eff.to.set(eff.msg)
                elif callable(eff.to):
                    eff.to(eff.msg)
                elif isinstance(eff.to, ServerId):
                    self.counters.incr(server.cfg.uid, "msgs_sent")
                    self.router.send(self.name, eff.to, eff.msg)
            elif isinstance(eff, ModCall):
                try:
                    eff.fn(*eff.args)
                except Exception:
                    logger.exception("mod_call effect failed")
            elif isinstance(eff, LogReadEffect):
                # bare form runs on every member; {local, Node} targets
                # one node (ra_server_proc.erl:1369-1397)
                if eff.local is None or eff.local == self.name:
                    entries = server.log.sparse_read(eff.indexes)
                    try:
                        follow_up = eff.fn(entries)
                        # a fn may return follow-up EFFECTS (reference
                        # recursion); anything non-iterable is treated
                        # as no effects, not a crash
                        follow_up = list(follow_up) if \
                            isinstance(follow_up, (list, tuple)) else []
                    except Exception:
                        logger.exception("log effect failed")
                        follow_up = []
                    if follow_up:
                        self._execute(shell, follow_up)
            elif isinstance(eff, AuxEffect):
                self._execute(shell, server.handle_aux("eval", eff.msg))
            elif isinstance(eff, Monitor):
                # per-component multiplexing (ra_monitors.erl:34-56):
                # machine monitors feed the machine a {down,..} command,
                # aux monitors feed handle_aux; node/peer monitoring is
                # subsumed by the transport failure detector
                if eff.kind == "process":
                    if eff.component == "machine":
                        shell.machine_monitors.add(eff.target)
                    elif eff.component == "aux":
                        shell.aux_monitors.add(eff.target)
            elif isinstance(eff, Demonitor):
                if eff.kind == "process":
                    if eff.component == "machine":
                        shell.machine_monitors.discard(eff.target)
                    elif eff.component == "aux":
                        shell.aux_monitors.discard(eff.target)
            elif isinstance(eff, GarbageCollection):
                self.counters.incr(server.cfg.uid, "forced_gcs")
            elif isinstance(eff, TimerEffect):
                # {timer, Name, T}: arm/cancel a named machine timer
                # (ra_server_proc.erl:1549-1550); ms=None cancels.
                # MACHINE CONTRACT: timers are local to this replica and
                # an expiry is routed through consensus only while it is
                # the leader (_poll_shell) — an expiry on a non-leader is
                # discarded, so a machine that must keep machine-time
                # alive across failover re-arms its timers in
                # state_enter(leader) (exactly the reference's posture:
                # the timeout command is leader-routed, ra_server_proc
                # .erl:556-560, and a deposed leader's pending timers
                # die with its leadership)
                if eff.ms is None:
                    shell.machine_timers.pop(eff.name, None)
                else:
                    shell.machine_timers[eff.name] = (
                        time.monotonic() + eff.ms / 1000.0, eff.msg)
            # unknown machine effects are ignored (forward compat)

    def _arm_election(self, shell: ServerShell, kind: str) -> None:
        lo, hi = _TIMEOUT_KINDS.get(kind, _TIMEOUT_KINDS["medium"])
        dur = shell.server.cfg.election_timeout_ms / 1000.0
        shell.election_deadline = time.monotonic() + random.uniform(
            lo * dur, hi * dur)

    def _send_snapshot(self, shell: ServerShell, eff: SendSnapshot) -> None:
        """Chunked snapshot send (spawned in ra, :1446-1488; inline here —
        memory-log snapshots are small; the durable log grows a thread)."""
        server = shell.server
        snap = server.log.snapshot()
        if snap is None:
            return
        self.counters.incr(server.cfg.uid, "snapshots_sent")
        meta, data = snap
        leader_id, term = eff.id_term
        # chunk boundaries come from the machine's snapshot module
        # (begin_read/read_chunk role, ra_snapshot.erl:129-143)
        chunks = list(server.log.snapshot_module.chunks(
            data, server.cfg.snapshot_chunk_size)) or [b""]
        for i, piece in enumerate(chunks):
            flag = "last" if i == len(chunks) - 1 else "next"
            self.counters.incr(server.cfg.uid, "msgs_sent")
            self.router.send(self.name, eff.to,
                             InstallSnapshotRpc(term=term,
                                                leader_id=leader_id,
                                                meta=meta,
                                                chunk_number=i + 1,
                                                chunk_flag=flag,
                                                data=piece,
                                                chunk_crc=zlib.crc32(piece),
                                                token=eff.token))

    # -- introspection -------------------------------------------------------

    def classic_stats(self) -> dict:
        """Replication-batching health across this node's members — the
        CLASSIC_FIELDS snapshot: AER batches sent, total
        entries they carried, entries/batch p50/p99/mean from the
        cores' bounded reservoirs.  ``records_per_fsync`` (the
        group-commit fan-in half of the pair) lives in ``Wal.stats()``
        — the embedding bench/Observatory stamps both side by side."""
        batches = 0
        entries = 0
        sizes: list = []
        for shell in list(self.shells.values()):
            srv = shell.server
            batches += srv.stats.get("aer_batches_sent", 0)
            entries += srv.stats.get("aer_batch_entries", 0)
            # the event-loop thread appends concurrently (maxlen'd, so
            # a full deque mutates on every append): copy into a FRESH
            # list with retries rather than crash a stats probe
            # mid-traffic (a partial extend must not duplicate)
            got: list = []
            for _ in range(4):
                try:
                    got = list(srv._aer_batch_sizes)
                    break
                except RuntimeError:
                    got = []
            sizes.extend(got)
        sizes.sort()
        n = len(sizes)
        # encode share: co-hosted members fan into ONE wal
        # carrying the system-wide phase accumulator — the first shell
        # that reaches it answers for the node
        enc_pct = -1.0
        for shell in list(self.shells.values()):
            ph = getattr(getattr(shell.server.log, "wal", None),
                         "phases", None)
            if ph is not None:
                enc_pct = ph.encode_share_pct()
                break
        return {
            "aer_batches_sent": batches,
            "aer_batch_entries": entries,
            "entries_per_batch_mean":
                round(entries / batches, 2) if batches else -1.0,
            "entries_per_batch_p50": sizes[n // 2] if n else -1,
            "entries_per_batch_p99":
                sizes[min(n - 1, int(n * 0.99))] if n else -1,
            "encode_share_pct": enc_pct,
        }

    def overview(self) -> dict:
        return {
            "name": self.name,
            "servers": {n: s.server.overview()
                        for n, s in self.shells.items()},
            "leaderboard": dict(self.leaderboard),
        }
