"""One rung of the wire-plane connection-ladder soak.  Counterpart of
``ra_tpu/wire/soak.py::run_wire_soak`` on the port's engine, which runs
on the card unless the caller passes ``device="cpu"``.

:func:`run_wire_soak`: ``conns`` wire connections fan ops through the
full wire path -- fixed-stride DATA encode, per-connection rings,
vectorised sweep, ingress dedup/admission/coalescing, fused dispatch --
with credit verdicts and commit-watermark ACKs flowing back, a mid-run
reconnect storm (epoch bumps and at-least-once replay), member-failure
and election chaos on the lane plane, a lossy transport FaultPlan in the
process registry for the run's length, and (durable variant, optionally)
a seeded DiskFaultPlan injecting real WAL faults.  The
exactly-once-observable oracle closes the run: every op's delta applied
exactly once (machine-level dedup absorbs the storm's duplicate rows),
every ranked op acked.  The tail row carries ``wire_cmds_per_s``,
``wire_shed_rate`` and ``wire_reconnect_recovery_s``.

``mesh=True`` shards the engine over ``lane_mesh(member_axis=1)`` (one
slot a visible card), a ``LaneMesh`` over that mesh, with one WAL shard
a lane slot on the durable variant (``per_device_wal_shards``).

Transports: ``socket_conns`` real-socket ``WireClient``s against the
TCP listener ride beside the loopback fleet, which shares every byte of
the ring/sweep/framing path (wire/server.py).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from .client import PLACED, LoopbackFleet, WireClient
from .dedup import DedupCounterMachine
from .framing import data_stride
from .server import WireListener


def run_wire_soak(seed: int, *, conns: int = 10_000,
                  sessions_per_conn: int = 1, lanes: int = 512,
                  waves: int = 12, wave_ops: int = 50_000,
                  durable_dir: Optional[str] = None,
                  disk_faults: bool = False, superstep_k: int = 4,
                  cmds: int = 16, wal_shards: int = 2,
                  socket_conns: int = 0, socket_ops: int = 32,
                  storm_frac: float = 0.25,
                  storm_wave: Optional[int] = None,
                  ring_records: int = 32, tenants: int = 16,
                  mesh=False, device=None,
                  on_wave: Optional[Callable[[int], None]] = None) -> dict:
    """One ladder rung; returns a bench-comparable tail row.  See the
    module docstring for the scenario.  ``device`` is the engine's
    (None: the card).  ``on_wave(w)``, when given, is called as wave
    ``w`` starts and with ``waves`` as the drain starts, so a caller can
    trace a window of the measured waves."""
    from ..engine import LockstepEngine
    from ..ingress import IngressPlane
    from ..transport.rpc import FaultPlan, FaultSpec
    device_mesh = None
    if mesh:
        from ..parallel.mesh import (lane_mesh, per_device_wal_shards,
                                     shard_engine_state)
        device_mesh = lane_mesh(member_axis=1) if mesh is True else mesh
        if durable_dir is not None:
            wal_shards = per_device_wal_shards(device_mesh)
    rng = np.random.default_rng(seed)
    sessions = conns * sessions_per_conn + socket_conns
    slots = 4 * max(1, sessions // lanes) + 64
    ring = max(512, superstep_k * cmds * 4)
    machine = DedupCounterMachine(slots=slots)
    if durable_dir is not None:
        from ..engine.durable import open_engine
        eng = open_engine(machine, durable_dir, lanes,
                          wal_shards=wal_shards, ring_capacity=ring,
                          max_step_cmds=cmds, device=device)
    else:
        eng = LockstepEngine(machine, lanes, 3, ring_capacity=ring,
                             max_step_cmds=cmds, device=device)
    if device_mesh is not None:
        shard_engine_state(eng, device_mesh)
    disk_plan = None
    net_plan = FaultPlan(seed=seed, default=FaultSpec(drop=0.1))
    if disk_faults:
        from ..log import faults
        disk_plan = faults.DiskFaultPlan(
            seed=seed, by_class={"wal": faults.DiskFaultSpec(
                fsync_eio=0.05, short_write=0.02, limit=4)})
        faults.install_plan(disk_plan)
    plane = IngressPlane(eng, superstep_k=superstep_k,
                         window_s=0.001, soft_credit=1 << 20,
                         hard_credit=1 << 20)
    lst = WireListener(
        plane, port=0 if socket_conns else None,
        max_conns=conns + socket_conns + 8,
        ring_bytes=ring_records * data_stride(eng.payload_width))
    side_cars: list = []
    try:
        fleet = LoopbackFleet(
            lst, conns, sessions_per_conn=sessions_per_conn,
            key="ladder", tenants=tenants, seed=seed,
            max_ops=waves * wave_ops + wave_ops + 1024)
        assert int(fleet.slots.max()) < slots, "dedup slot overflow"
        for i in range(socket_conns):
            side_cars.append(WireClient(lst.address, key=f"sock/{i}",
                                        n_sessions=1))
        # warm the fused/settle/read executables outside the measured
        # window (zero-delta ops leave the oracle untouched)
        fleet.new_ops(rng.integers(0, fleet.n_sessions,
                                   min(1024, wave_ops)),
                      np.zeros(min(1024, wave_ops), np.int32))
        _cycle(fleet, lst, plane)
        plane.settle()
        fleet.collect()
        eng.consistent_read([0])
        failed_member = None
        storm_at = waves // 2 if storm_wave is None else storm_wave
        storm_ops: Optional[np.ndarray] = None
        storm_t = recovery_s = -1.0
        placed_base = lst.counters["credit_ok"] + \
            lst.counters["credit_slow"]
        work_s = 0.0
        t0 = time.perf_counter()
        for w in range(waves):
            if on_wave is not None:
                on_wave(w)
            tw = time.perf_counter()
            sess = rng.integers(0, fleet.n_sessions, wave_ops)
            fleet.new_ops(sess, rng.integers(1, 8, wave_ops)
                          .astype(np.int32))
            _cycle(fleet, lst, plane)
            work_s += time.perf_counter() - tw
            for cli in side_cars:
                for _ in range(socket_ops):
                    cli.enqueue(int(rng.integers(1, 8)))
                cli.flush()
                cli.poll()  # prompt verdict processing: refusals re-key
            if w == storm_at:
                # NO settle barrier here: a connection kill only loses
                # ring bytes (client-replayed), never committed state —
                # the settle discipline is for LEADER kills below
                storm_t = time.perf_counter()
                storm_ops = fleet.storm(storm_frac)
                for cli in side_cars:
                    cli.reconnect()
            if storm_ops is not None and recovery_s < 0:
                tw = time.perf_counter()
                _cycle(fleet, lst, plane)
                work_s += time.perf_counter() - tw
                if (fleet.op_state[storm_ops] == PLACED).all():
                    recovery_s = time.perf_counter() - storm_t
            if w % 4 == 2:
                if durable_dir is not None:
                    plane.settle(timeout=120.0)
                    fleet.collect()
                if failed_member is not None:
                    lane_c, slot = failed_member
                    if int(eng.state.leader_slot[lane_c]) != slot:
                        eng.recover_member(lane_c, slot)
                    failed_member = None
                lane_c = int(rng.integers(lanes))
                slot = int(eng.state.leader_slot[lane_c])
                eng.fail_member(lane_c, slot)
                eng.trigger_election([lane_c])
                failed_member = (lane_c, slot)
        # drain: at-least-once means every op retries until placed
        if on_wave is not None:
            on_wave(waves)
        tw = time.perf_counter()
        deadline = time.monotonic() + 120.0
        while fleet.unplaced_count() > 0:
            _cycle(fleet, lst, plane)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"wire drain: {fleet.unplaced_count()} ops "
                    "unplaced")
        plane.settle(timeout=120.0)
        fleet.collect()
        if storm_ops is not None and recovery_s < 0:
            recovery_s = time.perf_counter() - storm_t
        work_s += time.perf_counter() - tw
        elapsed = time.perf_counter() - t0
        # side-car clients drain the same way (per-conn scale)
        for cli in side_cars:
            cli_deadline = time.monotonic() + 30.0
            while cli.pending_count() or cli.unacked_count():
                cli.flush()
                lst.sweep()
                plane.pump(force=True)
                plane.settle()
                cli.poll()
                if time.monotonic() > cli_deadline:
                    raise TimeoutError("side-car drain")
        # -- the exactly-once-observable oracle -------------------------
        expected = fleet.expected_lane_sums(lanes)
        for cli in side_cars:
            h = cli.handle_base
            lane_h = int(plane.directory.lane[h])
            expected[lane_h] += sum(cli.op_pay)
        mac = eng.consistent_read(np.arange(lanes))
        got = np.asarray(mac["value"]).astype(np.int64)
        np.testing.assert_array_equal(got, expected)
        ranked = fleet.op_rank[:fleet.n_ops] >= 0
        acked = fleet.acked_mask()
        assert acked[ranked].all(), \
            f"{int((~acked[ranked]).sum())} ranked ops never acked"
        assert int(fleet.watermark.sum()) >= int(ranked.sum())
        # bounded buffers: every ring drained, no hidden queue
        assert int(lst.rfill.max(initial=0)) == 0
        assert plane.gauges()["queue_rows"] == 0
        # shed fairness: hashed placement must spread overflow — no
        # tenant eats a disproportionate share of the sheds
        fairness = _shed_fairness(fleet)
        if fairness is not None:
            assert fairness < 3.0, f"shed unfair: {fairness:.2f}"
        placed = lst.counters["credit_ok"] + \
            lst.counters["credit_slow"] - placed_base
        throughput = placed / max(work_s, 1e-9)
        row = lst.bench_row(work_s, reconnect_recovery_s=recovery_s)
        row.update({
            "value": throughput,
            "wire_cmds_per_s": throughput,
            "wire_shed_fairness": fairness if fairness is not None
            else -1.0,
            "conns": conns, "sessions": sessions, "lanes": lanes,
            "socket_conns": socket_conns,
            "ops": int(fleet.n_ops),
            "dup_rows_absorbed": int(
                lst.counters["swept_rows"] - fleet.n_ops
                - sum(len(c.op_state) for c in side_cars)),
            "storm_requeued": int(len(storm_ops))
            if storm_ops is not None else 0,
            "elapsed_s": elapsed, "work_s": work_s,
            "durable": durable_dir is not None,
            "mesh": eng.mesh_shape(),
            "wal_shards": wal_shards if durable_dir is not None else 0,
            "disk_faults_injected":
                dict(disk_plan.counters) if disk_plan else {},
        })
        return row
    finally:
        for cli in side_cars:
            cli.close()
        lst.close()
        net_plan.unregister()
        if disk_faults:
            from ..log import faults
            faults.clear_plan()
        eng.close()


def _cycle(fleet: LoopbackFleet, lst: WireListener, plane) -> None:
    """One pump of the whole loop: fleet send → sweep → credit →
    dispatch → ack."""
    fleet.send_queued()
    lst.sweep()
    fleet.collect()
    plane.pump(force=True)
    fleet.collect()


def _shed_fairness(fleet: LoopbackFleet) -> Optional[float]:
    """max tenant shed share / overall shed share; None when (almost)
    nothing was shed."""
    shed = fleet.tenant_shed
    rows = fleet.tenant_rows
    if shed.sum() < 100:
        return None
    overall = shed.sum() / max(1, rows.sum())
    seen = rows > 0
    shares = shed[seen] / rows[seen]
    return float(shares.max() / max(overall, 1e-12))



def ladder_main(seed: int, rungs, *, durable: bool = False,
                disk_faults: bool = False, socket_conns: int = 64,
                **kw) -> list:
    """Climb the ladder (``tools/soak.py --wire``'s rungs): one soak per
    rung, socket side-car on the first (smallest) rung only, a FRESH WAL
    dir per durable rung (rungs are independent runs, not restarts).
    ``kw`` goes to :func:`run_wire_soak` (``device="cpu"`` for the CPU);
    each row is stamped with :func:`ra_tpu_torch.utils.host_envelope`."""
    import json
    import tempfile

    from ..utils import host_envelope
    out = []
    for i, conns in enumerate(rungs):
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="wire_soak_") as d:
            res = run_wire_soak(
                seed, conns=conns,
                socket_conns=socket_conns if i == 0 else 0,
                wave_ops=max(20_000, conns // 2),
                ring_records=16 if conns >= 1 << 19 else 32,
                durable_dir=d if durable else None,
                disk_faults=disk_faults, **kw)
        res["rung"] = f"C{conns}"
        res["host"] = host_envelope()
        print(f"wire C{conns}: {res['wire_cmds_per_s']:.0f} cmds/s  "
              f"shed={res['wire_shed_rate']:.4f}  "
              f"recovery={res['wire_reconnect_recovery_s']:.2f}s  "
              f"({time.time() - t0:.1f}s)", flush=True)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out
