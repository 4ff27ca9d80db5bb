"""The geo survival soak: the port's copy of ``ra_tpu/placement/geo.py``,
the placement tier across four OS processes, with the lane engines on
``device`` (None: the card).

* the parent ("ctl") hosts one placement-table member, the
  :class:`~ra_tpu_torch.placement.supervisor.EngineSupervisor` (probing
  over the reliable RPC tier through
  :class:`~ra_tpu_torch.placement.fabric.RpcEngineProbe`) and the wire
  clients;
* a control child ("far") hosts the other two table members behind an
  80-150 ms latency-domain matrix: every control commit pays at least
  one cross-domain round trip for its quorum (the CD-Raft shape);
* two engine children each run a
  :class:`~ra_tpu_torch.placement.host.LaneEngineHost` (its engine on
  the card) serving a real TCP wire listener, fronted by a
  :class:`~ra_tpu_torch.placement.fabric.HostAgent`; the engine tier is
  local, the delay matrix does not touch it.

One run (:func:`run_geo_soak`): live wire traffic against both engine
children; a delay-only episode that stretches the control→engine
crossing by the same 80-150 ms and must see zero migrations and zero
down verdicts (geography is not death); SIGKILL of one engine child
mid-traffic, detection, a generation-gated migration committed across
the matrix, ``host_adopt`` of the victim's durable directory by the
survivor, ``host_placement`` and ``host_rehome`` with
:meth:`WireClient.rehome_to`; then the exactly-once oracle over both
engines, read back over ``host_lane_sums``.

The row stamps ``geo_failover_recovery_s`` (SIGKILL → first commit on
the new home) and ``geo_false_migrations`` (0), and, beyond the
reference's row, ``engine_launches``: each kernel's launches in the
victim just before its SIGKILL and in the survivor just before teardown
(the ``geo_launches`` control op).  Each child's stderr goes to a file in
the run's data directory; its tail rides any ``TimeoutError``.  This
module is its own child entry point
(``python -m ra_tpu_torch.placement.geo --child ...``).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..blackbox import record
from ..device import resolve_device
from ..trace import new_trace_ctx
from ..utils import host_envelope

#: the latency geometry: control followers are far, engines are local
_DELAY_MS = (80.0, 150.0)
#: the directory holding this checkout's ``ra_tpu_torch``: children import
#: the parent's port, whatever the working directory
_PORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _geo_members() -> dict:
    return {"ctl": ["ctl"], "far": ["gf1", "gf2"],
            "eng": ["n_engA", "n_engB"]}


def _geo_plan(local: str, seed: int, *, eng_delay: bool = False):
    """The latency-domain FaultPlan one process of the geo topology
    installs; ``eng_delay`` adds the control→engine crossing (the
    delay-only episode's knob)."""
    from ..transport.rpc import FaultPlan
    matrix: dict = {("ctl", "far"): {"delay_ms": _DELAY_MS}}
    if eng_delay:
        matrix[("ctl", "eng")] = {"delay_ms": _DELAY_MS}
    return FaultPlan(seed=seed, domains={
        "local": local, "members": _geo_members(), "matrix": matrix})


def _tune_detector(router) -> None:
    """Transport detector thresholds above the matrix's RTT (reliable RPC
    refuses suspect peers: flapping would starve the commit path)."""
    router.suspect_after = 2.0
    router.down_after = 6.0
    router.detector_hysteresis = 0.5


def _await(what: str, timeout_s: float, fn: Callable[[], bool], *,
           tick: Optional[Callable[[], None]] = None,
           sleep_s: float = 0.01) -> int:
    """Deadline-bounded progress wait (the one retry shape RA16 allows):
    polls ``fn``, driving ``tick`` between polls, and records the give-up
    event on exhaustion."""
    deadline = time.monotonic() + timeout_s
    attempts = 0
    while time.monotonic() < deadline:
        attempts += 1
        if tick is not None:
            tick()
        if fn():
            return attempts
        time.sleep(sleep_s)
    record("placement.giveup", what=what, attempts=attempts)
    raise TimeoutError(f"geo soak: {what} not reached in {timeout_s}s")


def _machine_slots(sessions: int, lanes: int) -> int:
    """Dedup slots a lane (the child builds the machine, the parent's
    client asserts against it)."""
    return 4 * max(1, sessions // lanes) + 64


def _write_ready(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # atomic: the parent never reads a torn file


def _launches() -> dict:
    """Each kernel wrapper's launches in this process."""
    from ..ops import commit_phase, fifo_fold, pallas_quorum, slot_fold
    return {"evaluate_quorum": pallas_quorum.LAUNCHES,
            "commit_phase": commit_phase.LAUNCHES,
            "slot_fold": slot_fold.LAUNCHES, "fifo_fold": fifo_fold.LAUNCHES}


# ----------------------------------------------------------------------
# child entry points (one OS process each)
# ----------------------------------------------------------------------


def _engine_stack(args) -> tuple:
    """The engine child's serving stack before its loop: TcpRouter,
    RaNode, LaneEngineHost (real TCP wire listener, engine on
    ``args.device``) and HostAgent."""
    from ..node import RaNode
    from ..transport.tcp import TcpRouter
    from ..wire.dedup import DedupCounterMachine
    from .fabric import HostAgent
    from .host import LaneEngineHost
    eid = args.eid
    router = TcpRouter(("127.0.0.1", 0),
                       {"ctl": (args.parent_host, args.parent_port)})
    router.set_fault_plan(_geo_plan("eng", args.seed))
    _tune_detector(router)
    node = RaNode(f"n_{eid}", router=router)
    slots = _machine_slots(args.sessions, args.lanes)
    host = LaneEngineHost(
        eid, args.data_dir,
        machine_factory=lambda: DedupCounterMachine(slots=slots),
        lanes=args.lanes, wal_shards=args.wal_shards, max_conns=16,
        port=0, device=args.device)
    agent = HostAgent(host, node, placement_rid=f"{eid}/lanes")
    node.control_ops["geo_launches"] = lambda a: _launches()
    return router, node, host, agent


def _engine_child(args) -> None:
    """One lane-engine host process, pumping until stopped, killed, or
    the run deadline."""
    router, node, host, agent = _engine_stack(args)
    _write_ready(args.ready, {
        "router": list(router.listen_addr),
        "wire": list(host.listener.address),
        "node": node.name, "pid": os.getpid()})
    deadline = time.monotonic() + args.max_run_s
    n = 0
    while time.monotonic() < deadline and not agent.stopped.is_set():
        agent.pump()
        host.cycle()
        n += 1
        if n % 64 == 0:
            # drive the async committed-watermark readbacks so ACK
            # watermarks stay live between the parent's waves
            try:
                host.settle(timeout=2.0)
            except (TimeoutError, RuntimeError):
                pass
        time.sleep(0.002)
    if not agent.stopped.is_set():
        record("placement.giveup", what="geo_engine_child_deadline",
               attempts=n)
    host.close()
    node.stop()
    router.stop()


def _control_child(args) -> None:
    """The far latency domain: one TcpRouter hosting both remote table
    nodes (gf1, gf2), 80-150 ms from the parent's domain; the parent
    starts the table members on them over the control plane."""
    import threading
    from ..node import RaNode
    from ..transport.tcp import TcpRouter
    from . import table as _table  # registers the machine spec  # noqa: F401
    router = TcpRouter(("127.0.0.1", 0),
                       {"ctl": (args.parent_host, args.parent_port)})
    router.set_fault_plan(_geo_plan("far", args.seed))
    _tune_detector(router)
    stop = threading.Event()
    nodes = [RaNode("gf1", router=router), RaNode("gf2", router=router)]
    nodes[0].control_ops["geo_stop"] = \
        lambda a: (stop.set(), "stopping")[1]
    _write_ready(args.ready, {
        "router": list(router.listen_addr),
        "node": "gf1,gf2", "pid": os.getpid()})
    deadline = time.monotonic() + args.max_run_s
    waited = 0
    while time.monotonic() < deadline and not stop.is_set():
        time.sleep(0.05)
        waited += 1
    if not stop.is_set():
        record("placement.giveup", what="geo_control_child_deadline",
               attempts=waited)
    for n in nodes:
        n.stop()
    router.stop()


def _spawn_child(role: str, ready: str, parent_addr: tuple,
                 seed: int, max_run_s: float, **kw) -> subprocess.Popen:
    """Start one child on this checkout's port (``PYTHONPATH``), its
    stderr in ``<ready>.err``; the card stays visible to it."""
    argv = [sys.executable, "-m", "ra_tpu_torch.placement.geo",
            "--child", role, "--ready", ready,
            "--parent-host", parent_addr[0],
            "--parent-port", str(parent_addr[1]),
            "--seed", str(seed), "--max-run-s", str(max_run_s)]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_PORT_ROOT if not path
               else _PORT_ROOT + os.pathsep + path)
    with open(ready + ".err", "wb") as err:
        return subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                                stderr=err)


def _read_ready(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _child_tails(ready: dict, n_bytes: int = 2000) -> str:
    """The end of each child's stderr file, for an error message."""
    out = []
    for role, path in ready.items():
        try:
            with open(path + ".err", "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n_bytes))
                tail = f.read().decode(errors="replace")
        except OSError as exc:
            tail = repr(exc)
        out.append(f"--- {role} stderr ---\n{tail}")
    return "\n".join(out)


# ----------------------------------------------------------------------
# the parent orchestration
# ----------------------------------------------------------------------


def run_geo_soak(seed: int, *, sessions: int = 24, lanes: int = 16,
                 waves: int = 5, wave_ops: int = 300,
                 wal_shards: int = 2,
                 delay_episode_s: float = 2.5,
                 data_dir: Optional[str] = None,
                 max_run_s: float = 300.0,
                 recovery_bar: Optional[float] = None,
                 device=None) -> dict:
    """One geo run; returns the tail row.  See the module docstring for
    the scenario.  ``device`` is the engine children's (None: the card,
    resolved here, so a missing card raises before any child starts)."""
    from ..api import process_command, start_cluster
    from ..core.types import ErrorResult, ServerId
    from ..node import RaNode
    from ..transport.rpc import reliable_node_call
    from ..transport.tcp import TcpRouter
    from ..wire.client import WireClient
    from .fabric import (RpcEngineProbe, push_placement, remote_adopt,
                         remote_lane_sums, remote_rehome)
    from .supervisor import EngineSupervisor
    from .table import placement_spec
    dev = str(resolve_device(device))
    rng = np.random.default_rng(seed)
    tmp = None
    if data_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="geo-soak-")
        data_dir = tmp.name
    os.makedirs(data_dir, exist_ok=True)    # the children's stderr files
    dirs = {e: os.path.join(data_dir, e) for e in ("engA", "engB")}
    ready = {r: os.path.join(data_dir, f"{r}.ready")
             for r in ("far", "engA", "engB")}
    base_plan = _geo_plan("ctl", seed)
    router = TcpRouter(("127.0.0.1", 0), {})
    router.set_fault_plan(base_plan)
    _tune_detector(router)
    ctl = RaNode("ctl", router=router)
    procs: dict = {}
    clients: dict = {}
    row: dict = {}
    try:
        # -- topology: one far control child + two engine children ---
        procs["far"] = _spawn_child("control", ready["far"],
                                    router.listen_addr, seed, max_run_s)
        for eid in ("engA", "engB"):
            procs[eid] = _spawn_child(
                "engine", ready[eid], router.listen_addr, seed,
                max_run_s, eid=eid, data_dir=dirs[eid], lanes=lanes,
                sessions=sessions, wal_shards=wal_shards, device=dev)

        def _children_ready() -> bool:
            dead = {r: p.returncode for r, p in procs.items()
                    if p.poll() is not None}
            if dead:
                raise RuntimeError(f"geo soak: child exited before ready "
                                   f"{dead}\n{_child_tails(ready)}")
            return all(os.path.exists(p) for p in ready.values())
        _await("geo_children_ready", 120.0, _children_ready, sleep_s=0.05)
        info = {r: _read_ready(p) for r, p in ready.items()}
        for n in ("gf1", "gf2"):
            router.address_book[n] = tuple(info["far"]["router"])
        for eid in ("engA", "engB"):
            router.address_book[f"n_{eid}"] = \
                tuple(info[eid]["router"])
        node_of = {eid: f"n_{eid}" for eid in ("engA", "engB")}
        wire_of = {eid: tuple(info[eid]["wire"])
                   for eid in ("engA", "engB")}

        # -- control plane: the table quorum spans the delay matrix --
        sids = [ServerId("pt1", "ctl"), ServerId("pt2", "gf1"),
                ServerId("pt3", "gf2")]
        start_cluster("geo_pt", placement_spec(), sids, router=router,
                      election_timeout_ms=800, tick_interval_ms=200)
        sup = EngineSupervisor(
            sids[0], router, suspect_after=0.75, down_after=2.5,
            hysteresis=0.5, commit_timeout=10.0)
        probes = {}
        for eid in ("engA", "engB"):
            p = RpcEngineProbe(router, node_of[eid], eid, timeout=1.5,
                               min_interval=0.05)
            sup.watch(eid, p)
            p.bind(sup)
            probes[eid] = p
        adopted_addr: dict = {}

        def _on_migrate(victim, survivor, placements, trace_ctx):
            adopted_addr[victim] = remote_adopt(
                router, node_of[survivor], victim, dirs[victim],
                survivor=survivor, rid=f"{victim}/lanes",
                timeout=90.0, trace_ctx=trace_ctx)
        sup.on_migrate = _on_migrate
        for cmd in (("register_engine", "engA"),
                    ("register_engine", "engB"),
                    ("assign", "engA/lanes", "engA", 0, lanes),
                    ("assign", "engB/lanes", "engB", 0, lanes)):
            res = sup._commit(lambda c=cmd: process_command(
                sids[0], c, router, timeout=15.0), what="geo_setup")
            assert not isinstance(res, ErrorResult)
        state0 = sup.table_state()
        for eid in ("engA", "engB"):
            push_placement(router, node_of[eid], state0, timeout=15.0)

        # -- live wire traffic over real TCP -------------------------
        mslots = _machine_slots(sessions, lanes)
        for eid in ("engA", "engB"):
            c = WireClient(wire_of[eid], f"geo{seed}/{eid}",
                           n_sessions=sessions, tenants=2,
                           timeout=20.0)
            assert int(np.max(c.slots)) < mslots, "dedup slot overflow"
            clients[eid] = c
        victim, survivor = "engA", "engB"
        killed = False
        handled: set = set()  # engines whose down verdict was acted on
        launches: dict = {}

        def _live() -> list:
            return [e for e in ("engA", "engB")
                    if not (e == victim and killed
                            and e not in handled)]

        def _failover(eid: str) -> None:
            surv = "engB" if eid == "engA" else "engA"
            ctx = new_trace_ctx("geo-failover")
            record("placement.refuse", trace=ctx, engine=eid,
                   unplaced=int(_unplaced(eid)))
            sup.failover(eid, surv, trace_ctx=ctx)  # on_migrate adopts
            # the survivor's serving view learns the committed move
            # before the client is re-pointed, so its placement mask
            # routes the re-homed sessions instead of refusing them
            push_placement(router, node_of[surv], sup.table_state(),
                           timeout=15.0)
            durable = remote_rehome(router, node_of[surv], eid,
                                    clients[eid], timeout=60.0,
                                    trace_ctx=ctx)
            clients[eid].rehome_to(adopted_addr[eid], durable)

        def _pump() -> None:
            # a down verdict, never a mere delay, is the one migration
            # trigger: the delay episode's zero-migration check is real
            for eid in sup.tick():
                if eid not in handled:
                    handled.add(eid)
                    _failover(eid)
            for e in _live():
                try:
                    clients[e].flush()
                    clients[e].poll()
                except OSError:
                    pass

        def _unplaced(e: str) -> int:
            c = clients[e]
            return sum(1 for s in c.op_state if s != 2)

        def _undrained(e: str) -> int:
            # placed is a sweep verdict; the oracle reads committed
            # state, so drain until every ranked op is acked.  A DUP-placed
            # replay never ranks: its delta is in the recovered state
            c = clients[e]
            ranked_unacked = sum(
                1 for i in range(len(c.op_state))
                if c.op_rank[i] >= 0 and not c._acked(i))
            return _unplaced(e) + ranked_unacked

        def _wave() -> None:
            for e in _live():
                c = clients[e]
                for _ in range(wave_ops):
                    c.enqueue(int(rng.integers(1, 8)),
                              sess=int(rng.integers(0, sessions)))
            _await("geo_wave_placed", 60.0,
                   lambda: all(_unplaced(e) == 0 for e in _live()),
                   tick=_pump)

        t0 = time.perf_counter()
        _wave()  # warm both serving paths end to end

        # -- episode 1: delay is not death ---------------------------
        downs0 = sup.counters["downs"]
        mig0 = sup.counters["migrations"]
        router.set_fault_plan(_geo_plan("ctl", seed, eng_delay=True))
        ep_end = time.monotonic() + delay_episode_s
        _wave()
        _await("geo_delay_episode", delay_episode_s + 30.0,
               lambda: time.monotonic() >= ep_end, tick=_pump)
        router.set_fault_plan(base_plan)
        false_migrations = sup.counters["migrations"] - mig0
        assert sup.counters["downs"] == downs0, \
            "delay-only episode produced a down verdict"
        assert false_migrations == 0, \
            "delay-only episode migrated an engine (geography as death)"

        # -- episode 2: SIGKILL one engine host ----------------------
        for w in range(waves):
            if w == waves // 2 and not killed:
                launches[victim] = reliable_node_call(
                    router, node_of[victim], "geo_launches", {},
                    timeout=15.0)
                os.kill(info[victim]["pid"], signal.SIGKILL)
                t_kill = time.perf_counter()
                killed = True
                wm = int(clients[victim].watermark.sum())
                _await("geo_detect_and_migrate", 60.0,
                       lambda: victim in handled, tick=_pump)
                _await("geo_recovery_commit", 90.0,
                       lambda: int(clients[victim].watermark.sum())
                       > wm, tick=_pump)
                recovery_s = time.perf_counter() - t_kill
            _wave()
        assert killed and victim in handled, "kill wave never ran"
        _await("geo_drain", 120.0,
               lambda: all(_undrained(e) == 0
                           for e in ("engA", "engB")), tick=_pump)
        elapsed = time.perf_counter() - t0

        # -- the exactly-once oracle over both engines ---------------
        got = {
            victim: remote_lane_sums(router, node_of[survivor],
                                     victim, timeout=30.0),
            survivor: remote_lane_sums(router, node_of[survivor],
                                       survivor, timeout=30.0),
        }
        launches[survivor] = reliable_node_call(
            router, node_of[survivor], "geo_launches", {}, timeout=15.0)
        lost = double = 0
        for eid in ("engA", "engB"):
            expected = _expected_lane_sums(clients[eid], lanes,
                                           f"geo{seed}/{eid}")
            lost += int(np.maximum(expected - got[eid], 0).sum())
            double += int(np.maximum(got[eid] - expected, 0).sum())
            np.testing.assert_array_equal(got[eid], expected)
        assert sup.counters["downs"] - downs0 == 1
        assert sup.counters["migrations"] >= 1
        if recovery_bar is not None:
            assert recovery_s <= recovery_bar, \
                f"recovery {recovery_s:.3f}s > bar {recovery_bar}s"
        row = {
            "value": recovery_s,
            "geo_failover_recovery_s": recovery_s,
            "geo_false_migrations": int(false_migrations),
            "geo_lost_acked": lost,
            "geo_double_applied": double,
            "seed": seed, "sessions": 2 * sessions, "lanes": lanes,
            "ops": int(sum(len(clients[e].op_state)
                           for e in clients)),
            "migrations": int(sup.counters["migrations"]),
            "stale_probe_drops":
                int(sup.counters["stale_probe_drops"]),
            "rehome_follows":
                int(sum(clients[e].rehome_follows for e in clients)),
            "probe_replies":
                {e: int(probes[e].replies) for e in probes},
            "detector": {k: int(sup.counters[k]) for k in
                         ("heartbeats", "suspects", "downs",
                          "recoveries")},
            "domain_matrix": base_plan.overview().get("domain_matrix"),
            "elapsed_s": elapsed, "wal_shards": wal_shards,
            "host": host_envelope(),
            "engine_launches": launches,
        }
        return row
    except TimeoutError as exc:
        raise TimeoutError(f"{exc}\n{_child_tails(ready)}") from exc
    finally:
        _teardown(router, ctl, procs, clients, node_of={
            "engA": "n_engA", "engB": "n_engB"})
        if tmp is not None:
            tmp.cleanup()


def _expected_lane_sums(client, lanes: int, key: str) -> np.ndarray:
    """The oracle's truth, rebuilt in the parent: the key→lane hash is
    deterministic per (seed, key), so a shadow directory re-derives the
    lane each of the client's sessions was placed on in the child."""
    from ..ingress.sessions import SessionDirectory
    d = SessionDirectory(lanes, seed=0)
    h = d.connect_bulk(client.n_sessions, key=f"wire/{key}",
                       tenants=client.tenants)
    lane = d.lane[h]
    out = np.zeros(lanes, np.int64)
    for i in range(len(client.op_state)):  # control-plane scale
        out[lane[client.op_sess[i]]] += int(client.op_pay[i])
    return out


def _teardown(router, ctl, procs: dict, clients: dict,
              node_of: dict) -> None:
    from ..transport.rpc import reliable_node_call
    for c in clients.values():
        try:
            c.close()
        except OSError:
            pass
    for eid, node in node_of.items():
        try:
            reliable_node_call(router, node, "host_stop", {},
                               timeout=2.0)
        except (RuntimeError, TimeoutError):
            pass
    try:
        reliable_node_call(router, "gf1", "geo_stop", {}, timeout=2.0)
    except (RuntimeError, TimeoutError):
        pass
    for p in procs.values():
        try:
            p.terminate()
            p.wait(timeout=10.0)
        except (subprocess.TimeoutExpired, OSError):
            p.kill()
    ctl.stop()
    router.stop()


def geo_main(seeds, **kw) -> list:
    """One run a seed, a JSON tail a run."""
    rows = []
    for seed in seeds:
        res = run_geo_soak(int(seed), **kw)
        print(f"geo seed={seed}: "
              f"recovery={res['geo_failover_recovery_s']:.2f}s "
              f"false_migrations={res['geo_false_migrations']} "
              f"lost_acked={res['geo_lost_acked']} "
              f"migrations={res['migrations']}")
        print(json.dumps(res))
        rows.append(res)
    return rows


def _child_main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="ra_tpu_torch.placement.geo")
    ap.add_argument("--child", required=True,
                    choices=("engine", "control"))
    ap.add_argument("--ready", required=True)
    ap.add_argument("--parent-host", required=True)
    ap.add_argument("--parent-port", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-run-s", type=float, default=300.0)
    ap.add_argument("--eid", default="")
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--wal-shards", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card)")
    args = ap.parse_args(argv)
    if args.child == "engine":
        _engine_child(args)
    else:
        _control_child(args)


if __name__ == "__main__":
    _child_main()
