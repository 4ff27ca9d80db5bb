"""Driver entry points of the port (the twin of ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: one lockstep step of the
flagship configuration (the counter machine, 128 lanes x 3 members),
with its example inputs on the engine's device.

``dryrun_multichip(n)`` builds an ``n``-slot ``(members, lanes)`` mesh
and drives the reference's dryrun phases through sharded engines:
steady commits, a leader failure and election, a ``JitKvMachine`` apply
with its replicas converged across the member axis, a durable engine
under lane sharding (one WAL shard a lane slot) with checkpoint and
recovery, throughput rows per mesh shape and lane-ladder rung, and
chaos (failures, elections, membership churn) per rung.

Both run on the card unless the caller names the CPU:
``entry(device="cpu")``, ``dryrun_multichip(8, ["cpu"] * 8)``.
"""
from __future__ import annotations

import functools
import json
import random
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch


def _mk_engine(n_lanes: int, n_members: int, device, ring: int = 64,
               k: int = 8, machine=None):
    from .engine import LockstepEngine
    from .models import CounterMachine
    return LockstepEngine(machine or CounterMachine(), n_lanes, n_members,
                          ring_capacity=ring, max_step_cmds=k, device=device)


def entry(device=None):
    """One lockstep step of 128 lanes x 3 members over the counter
    machine, and its example arguments ``(state, n_new, payloads,
    fail_mask, elect_mask, confirm_upto, query_mask)``."""
    from .engine.lockstep import I32, _step
    from .models import CounterMachine

    eng = _mk_engine(128, 3, device)
    dev = eng.device
    fn = functools.partial(
        _step, n_read=torch.zeros((128,), dtype=I32, device=dev),
        read_q=torch.zeros((128, eng.read_window, eng.query_width),
                           dtype=eng.query_dtype, device=dev),
        machine=CounterMachine(), ring_capacity=eng.ring_capacity,
        apply_window=eng.apply_window, pipeline_window=4096,
        max_append_batch=128, write_delay=0)
    n_new = torch.full((128,), 4, dtype=I32, device=dev)
    payloads = torch.ones((128, eng.max_step_cmds, 1), dtype=I32, device=dev)
    fail = torch.zeros((128, 3), dtype=torch.bool, device=dev)
    elect = torch.zeros((128,), dtype=torch.bool, device=dev)
    confirm = torch.zeros((128,), dtype=I32, device=dev)
    query = torch.zeros((128,), dtype=torch.bool, device=dev)
    return fn, (eng.state, n_new, payloads, fail, elect, confirm, query)


def _slots(n_devices: int, devices: Optional[Sequence]) -> list:
    """The mesh's ``n_devices`` slots: the given devices, or one slot a
    visible card, the cards repeated in turn where there are fewer."""
    if devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(f"need {n_devices} mesh slots, got "
                               f"{len(devices)} devices")
        return list(devices)[:n_devices]
    from .device import resolve_device
    resolve_device(None)                 # raises without a card
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def _converged(mac: np.ndarray, active: np.ndarray) -> bool:
    """Every active replica of every lane equals the lane's first active
    replica."""
    ref = mac[np.arange(mac.shape[0]), np.argmax(active, axis=1)]
    diff = mac != ref[:, None]
    if diff.ndim > 2:
        diff = diff.reshape(diff.shape[0], diff.shape[1], -1).any(-1)
    return not (active & diff).any()


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     ladder: Optional[Sequence[int]] = None) -> dict:
    """Drive the dryrun's phases over an ``n_devices``-slot mesh (see the
    module docstring); a ``2 x (n/2)`` mesh with 4 members where ``n`` is
    even and at least 4, else ``1 x n`` with 3.  ``ladder`` overrides
    ``lane_ladder()``.  Raises on any miss; returns the phases' rows."""
    from .engine.durable import open_engine
    from .models import CounterMachine, JitKvMachine
    from .parallel.mesh import (ladder_rungs, lane_ladder, lane_mesh,
                                mesh_shapes, per_device_wal_shards,
                                shard_engine_state)

    slots = _slots(n_devices, devices)
    dev0 = slots[0]
    member_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = lane_mesh(slots, member_axis=member_axis)
    n_members = 4 if member_axis == 2 else 3
    n_lanes = 16 * (n_devices // member_axis)
    i32 = np.int32

    # -- steady commits ---------------------------------------------------
    eng = _mk_engine(n_lanes, n_members, dev0)
    shard_engine_state(eng, mesh)
    n_new = np.full((n_lanes,), 4, i32)
    payloads = np.ones((n_lanes, eng.max_step_cmds, 1), i32)
    for _ in range(2):
        eng.step(n_new, payloads)
    committed = eng.committed_total()
    if committed != n_lanes * 8:
        raise AssertionError(f"steady: committed {committed}, want "
                             f"{n_lanes * 8}")
    print(f"  phase steady ok: committed={committed}")

    # -- leader failure and election on the sharded state ---------------
    half = n_lanes // 2
    term_before = eng.state.term.cpu().numpy().copy()
    for lane in range(half):
        eng.fail_member(lane, 0)          # slot 0 leads a fresh lane
    eng.step(np.zeros_like(n_new), np.zeros_like(payloads),
             elect_mask=np.arange(n_lanes) < half)
    for _ in range(3):
        eng.step(n_new, payloads)
    st = eng.state
    term, leads = st.term.cpu().numpy(), st.leader_slot.cpu().numpy()
    if not ((term[:half] == term_before[:half] + 1).all()
            and (leads[:half] != 0).all()
            and (term[half:] == term_before[half:]).all()):
        raise AssertionError("election: terms or leaders wrong")
    total2 = eng.committed_total()
    if total2 <= committed or not _converged(st.mac.cpu().numpy(),
                                             st.active.cpu().numpy()):
        raise AssertionError(f"election: committed {total2}, replicas "
                             "diverged or commits stalled")
    print(f"  phase election ok: half-fleet re-elected, committed={total2}")

    # -- jit_kv apply, replicas converged across the member axis ---------
    kv = _mk_engine(n_lanes, n_members, dev0, machine=JitKvMachine(n_keys=16))
    shard_engine_state(kv, mesh)
    rng = np.random.default_rng(0)
    pays = np.zeros((n_lanes, 8, 4), i32)
    pays[..., 0] = 1                      # put
    pays[..., 1] = rng.integers(0, 16, (n_lanes, 8))
    pays[..., 2] = rng.integers(0, 1000, (n_lanes, 8))
    for _ in range(4):
        kv.step(np.full((n_lanes,), 8, i32), pays)
    kv_mac = kv.state.mac.cpu().numpy()
    kv_committed = kv.committed_total()
    if not (kv_mac == kv_mac[:, :1]).all() or kv_mac.max() <= 0 or \
            kv_committed != n_lanes * 8 * 4:
        raise AssertionError(f"jit_kv: committed {kv_committed} or "
                             "replicas diverged")
    print(f"  phase jit_kv ok: committed={kv_committed}, replicas converged")

    # -- durable engine under lane sharding -------------------------------
    ddir = tempfile.mkdtemp(prefix="dryrun_durable_")
    try:
        dn = 16 * n_devices
        lane_only = lane_mesh(slots, member_axis=1)
        kw = dict(sync_mode=1, ring_capacity=128, max_step_cmds=8,
                  wal_shards=per_device_wal_shards(lane_only), device=dev0)
        deng = open_engine(CounterMachine(), ddir, dn, 3, **kw)
        shard_engine_state(deng, lane_only)
        dpay = np.ones((dn, 8, 1), i32)
        for _ in range(5):
            deng.step(np.full((dn,), 4, i32), dpay)
        deng._dur.flush_all()
        for _ in range(4):
            deng.step(np.zeros((dn,), i32), np.zeros_like(dpay))
        committed_d = deng.committed_total()
        if committed_d <= 0 or deng.mesh_shape() != f"1x{n_devices}":
            raise AssertionError(f"durable: committed {committed_d}")
        deng.checkpoint()
        deng.close()
        deng2 = open_engine(CounterMachine(), ddir, dn, 3, **kw)
        recovered = deng2.committed_total()
        deng2.close()
        if recovered < committed_d:
            raise AssertionError(f"durable: recovered {recovered} < "
                                 f"{committed_d}")
        print(f"  phase durable-sharded ok: committed={committed_d}, "
              "recovered")
    finally:
        shutil.rmtree(ddir, ignore_errors=True)

    # -- throughput rows per mesh shape x lane-ladder rung ---------------
    ladder = list(ladder) if ladder is not None else lane_ladder()
    tput_rows = []
    for m_ax, l_ax, t_members in mesh_shapes(n_devices):
        tmesh = lane_mesh(slots, member_axis=m_ax)
        for t_lanes in ladder_rungs(ladder, l_ax):
            teng = _mk_engine(t_lanes, t_members, dev0)
            shard_engine_state(teng, tmesh)
            tn = np.full((t_lanes,), 8, i32)
            tp = np.ones((t_lanes, teng.max_step_cmds, 1), i32)
            teng.step(tn, tp)
            teng.block_until_ready()
            steps = 10 if t_lanes <= 8192 else 4
            t0 = time.perf_counter()
            for _ in range(steps):
                teng.step(tn, tp)
            teng.block_until_ready()
            dt = time.perf_counter() - t0
            tput_rows.append({"mesh": f"{m_ax}x{l_ax}", "lanes": t_lanes,
                              "members": t_members,
                              "platform": mesh.devices[0, 0].type,
                              "cmds_per_s": steps * t_lanes * 8 / dt})
            print(f"  phase throughput ok: {json.dumps(tput_rows[-1])}")
            del teng

    # -- chaos under sharding, per lane-ladder rung -----------------------
    chaos_rows = []
    for nc in ladder_rungs(ladder, n_devices // member_axis):
        chaos_rows.append(_chaos(nc, mesh, dev0))
        print(f"  phase chaos-sharded ok: {json.dumps(chaos_rows[-1])}, "
              "replicas converged")
    print(f"dryrun_multichip ok: mesh={mesh.shape} lanes={n_lanes} "
          f"members={n_members} "
          f"chaos_lanes={[r['lanes'] for r in chaos_rows]} "
          f"throughput={json.dumps(tput_rows)} "
          f"chaos={json.dumps(chaos_rows)} "
          "phases=steady,election,jit_kv,durable-sharded,"
          "throughput,chaos-sharded")
    return {"mesh": mesh.shape, "lanes": n_lanes, "members": n_members,
            "committed": committed, "committed_after_election": total2,
            "kv_committed": kv_committed, "durable_committed": committed_d,
            "throughput": tput_rows, "chaos": chaos_rows}


def _chaos(nc: int, mesh, dev0) -> dict:
    """The reference's chaos schedule on a sharded engine of ``nc`` lanes
    x 4 members: failures with batched elections, vectorized recoveries,
    membership churn and traffic, then heal and check convergence."""
    from .engine import LockstepEngine
    from .models import CounterMachine
    from .parallel.mesh import shard_engine_state

    crng = random.Random(42)
    pc = 4
    rounds = 12 if nc <= 8192 else 6
    ceng = LockstepEngine(CounterMachine(), nc, pc, ring_capacity=64,
                          max_step_cmds=4, write_delay=0, device=dev0)
    shard_engine_state(ceng, mesh)
    down: dict = {lane: set() for lane in range(nc)}
    removed: dict = {}
    pay_c = np.ones((nc, 4, 1), np.int32)
    n_c = np.full((nc,), 4, np.int32)
    prev_total = 0
    for _round in range(rounds):
        roll = crng.random()
        if roll < 0.45:
            ceng.step(n_c, pay_c)
        elif roll < 0.62:
            leads = ceng.state.leader_slot.cpu().numpy()
            elect_lanes = []
            for lane in crng.sample(range(nc), max(24, nc // 16)):
                if len(down[lane]) >= (pc - 1) // 2 or lane in removed:
                    continue
                victim = crng.choice([s for s in range(pc)
                                      if s not in down[lane]])
                ceng.fail_member(lane, victim)
                down[lane].add(victim)
                if victim == int(leads[lane]):
                    elect_lanes.append(lane)
            if elect_lanes:
                ceng.trigger_election(elect_lanes)
        elif roll < 0.78:
            leads = ceng.state.leader_slot.cpu().numpy()
            rl, rs = [], []
            for lane, dn in down.items():
                if dn:
                    slot = crng.choice(sorted(dn))
                    if slot != int(leads[lane]):
                        rl.append(lane)
                        rs.append(slot)
            for lane, slot in zip(rl, rs):
                down[lane].discard(slot)
            ceng.recover_members(rl, rs)
        elif roll < 0.9:
            leads = ceng.state.leader_slot.cpu().numpy()
            for lane in crng.sample(range(nc), min(64, max(12, nc // 32))):
                if lane in removed or down[lane]:
                    continue
                slot = crng.choice([s for s in range(pc)
                                    if s != int(leads[lane])])
                ceng.remove_member(lane, slot)
                removed[lane] = slot
        else:
            for lane, slot in list(removed.items()):
                ceng.add_member(lane, slot)
                ceng.promote_member(lane, slot)
                del removed[lane]
        total = ceng.committed_total()
        if total < prev_total:
            raise AssertionError("chaos: committed total regressed")
        prev_total = total
    for lane, slot in list(removed.items()):
        ceng.add_member(lane, slot)
        ceng.promote_member(lane, slot)
        del removed[lane]
    for _pass in range(2):
        leads = ceng.state.leader_slot.cpu().numpy()
        rl, rs = [], []
        for lane, dn in down.items():
            for slot in sorted(dn):
                if slot != int(leads[lane]):
                    rl.append(lane)
                    rs.append(slot)
        for lane, slot in zip(rl, rs):
            down[lane].discard(slot)
        ceng.recover_members(rl, rs)
        stalled = [lane for lane, dn in down.items() if dn]
        if not stalled:
            break
        ceng.trigger_election(stalled)
    if any(down.values()):
        raise AssertionError(f"chaos: lanes still down "
                             f"{[k for k, v in down.items() if v][:8]}")
    last = -1
    for _ in range(40):
        ceng.step(np.zeros((nc,), np.int32), np.zeros((nc, 4, 1), np.int32))
        cur = ceng.committed_total()
        if cur == last:
            break
        last = cur
    st = ceng.state
    if not _converged(st.mac.cpu().numpy(), st.active.cpu().numpy()) or \
            ceng.committed_total() <= 0:
        raise AssertionError("chaos: replicas diverged")
    return {"lanes": nc, "members": pc, "rounds": rounds,
            "committed": ceng.committed_total()}


if __name__ == "__main__":
    fn, args = entry()
    out, _aux = fn(*args)
    print("entry ok, committed:", int(out.total_committed.sum()))
