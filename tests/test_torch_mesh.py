"""The port's lane mesh (``ra_tpu_torch/parallel/mesh.py``, the sharded
``LockstepEngine`` of ``engine/shards.py``) against the reference's
sharded engine (``ra_tpu/parallel/mesh.py``).

The reference shards over the 8 forced host devices (``conftest.py``);
the port over 8 CPU slots, ``lane_mesh(["cpu"] * 8)``, as a ``1x8`` or a
``2x4`` mesh or both, most cases beside an unsharded port engine.  One
seeded schedule goes to every engine; after each verb every leaf of
every port engine equals the reference's, dtypes included (the twins of
the reference's mesh cases in ``test_superstep.py``,
``test_read_plane.py``, ``test_telemetry.py``, ``test_devicewatch.py``,
``test_engine_elections_adversarial.py``, ``test_ingress.py``,
``test_wire.py`` and ``__graft_entry__.py``).  Telemetry summaries merged
over shards: integer fields and offender lane ids exact, float32 sums
and means within a relative 1e-6 (the order of summation differs).

Card-only cases carry the ``cuda`` marker and skip here."""
import copy
import random

import jax
import numpy as np
import pytest
import torch

import ra_tpu.telemetry as ref_telemetry
import ra_tpu_torch.telemetry as port_telemetry
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.ingress import IngressPlane as RefPlane
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu.models import JitKvMachine as RefKv
from ra_tpu.models import TtlKvMachine as RefTtl
from ra_tpu.parallel import mesh as ref_mesh
from ra_tpu_torch import devicewatch
from ra_tpu_torch.convert import state_to_numpy
from ra_tpu_torch.engine import DispatchAheadDriver
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.engine.shards import LaneParts
from ra_tpu_torch.ingress import IngressPlane
from ra_tpu_torch.models import CounterMachine, JitKvMachine, TtlKvMachine
from ra_tpu_torch.parallel import mesh as port_mesh
from test_torch_engine import assert_same_arrays, ref_arrays

SLOTS = ["cpu"] * 8
N, P, KC = 16, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _private_reference_jit_caches():
    """The reference's engines here run sharded.  They get jit caches of
    their own, so that the reference's shared caches, and the recompile
    sentinel's last signature in each, stay as other test files leave
    them (an unsharded call after a sharded one at the same config
    counts as a recompile and records a ``device.recompile`` event)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ref_lockstep, "_STEP_JIT_CACHE", {})
        m.setattr(ref_lockstep, "_SUMMARY_JIT_CACHE", {})
        yield


def ref_devices():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8 forced host devices")
    return devices[:8]


def port_mesh_of(member_axis):
    return port_mesh.lane_mesh(SLOTS, member_axis=member_axis)


class Engines:
    """The reference's engine sharded over the host devices (its mesh's
    member axis ``ref_members``), and the port's engines sharded over
    each of ``port_members`` (1: ``1x8``, 2: ``2x4``) plus one unsharded:
    every verb goes to all, and ``check`` holds each port engine against
    the reference leaf by leaf."""

    def __init__(self, make_ref, make_port, ref_members=1,
                 port_members=(1, 2), unsharded=True):
        self.ref = make_ref()
        ref_mesh.shard_engine_state(self.ref, ref_mesh.lane_mesh(
            ref_devices(), member_axis=ref_members))
        self.ports = []
        for m in port_members:
            eng = make_port()
            port_mesh.shard_engine_state(eng, port_mesh_of(m))
            self.ports.append(eng)
        if unsharded:
            self.ports.append(make_port())

    @property
    def all(self):
        return [self.ref] + self.ports

    def verb(self, name, *args, **kw):
        return [getattr(e, name)(*args, **kw) for e in self.all]

    def check(self, what):
        want = ref_arrays(self.ref.state)
        for eng in self.ports:
            assert_same_arrays(state_to_numpy(eng.state), want,
                               f"{what} [{eng.mesh_shape() or 'unsharded'}]")


def machine_pair(name):
    if name == "jit_kv":
        return lambda: RefKv(n_keys=16), lambda: JitKvMachine(n_keys=16)
    return RefCounter, CounterMachine


def payloads(name, rng, k, n=N):
    """The reference superstep tests' command blocks [k, n, KC, C]."""
    if name == "jit_kv":
        p = np.zeros((k, n, KC, 4), np.int32)
        p[..., 0] = rng.integers(1, 5, (k, n, KC))
        p[..., 1] = rng.integers(0, 16, (k, n, KC))
        p[..., 2] = rng.integers(0, 100, (k, n, KC))
        p[..., 3] = rng.integers(-1, 5, (k, n, KC))
        return p
    return rng.integers(1, 9, (k, n, KC, 1)).astype(np.int32)


def superstep_engines(name, **kw):
    kw = dict(ring_capacity=64, max_step_cmds=KC, write_delay=1, **kw)
    mref, mport = machine_pair(name)
    return Engines(
        lambda: ref_lockstep.LockstepEngine(mref(), N, P, donate=False,
                                            superstep_donate=True, **kw),
        lambda: port_lockstep.LockstepEngine(mport(), N, P, device="cpu",
                                             **kw))


# -- the mesh and its placement ----------------------------------------------

def test_lane_mesh_shapes_and_refusals():
    mesh = port_mesh_of(2)
    assert mesh.shape == {"members": 2, "lanes": 4}
    assert mesh.shape == dict(ref_mesh.lane_mesh(ref_devices(),
                                                 member_axis=2).shape)
    assert port_mesh.mesh_shapes(8) == ref_mesh.mesh_shapes(8)
    assert port_mesh.ladder_rungs([1024, 64], 4) == \
        ref_mesh.ladder_rungs([1024, 64], 4)
    assert port_mesh.lane_ladder("") == ref_mesh.lane_ladder("")
    assert port_mesh.lane_ladder(" 64, 128") == [64, 128]
    assert port_mesh.per_device_wal_shards(mesh) == 4
    with pytest.raises(ValueError, match="member rows"):
        port_mesh.lane_mesh(["cpu"] * 3, member_axis=2)
    eng = port_lockstep.LockstepEngine(CounterMachine(), 4, 3, device="cpu")
    with pytest.raises(ValueError, match="at least"):
        port_mesh.shard_engine_state(eng, port_mesh_of(1))   # 8 > 4 lanes
    assert eng._mesh is None and eng.mesh_shape() == ""


def test_members_axis_keeps_ring_and_read_buf_lane_local():
    """A ``2x4`` mesh: the placement of every leaf is the reference's
    partition spec (``state_shardings``), the ring, ``read_buf`` and the
    ``[N]`` leaves stay whole on each lane shard's home slot, the member
    leaves split in two, and the joined state equals the unsharded
    engine's."""
    kw = dict(ring_capacity=32, max_step_cmds=KC, max_step_reads=3)
    ref = ref_lockstep.LockstepEngine(RefKv(8), N, 4, donate=False, **kw)
    want = ref_mesh.state_shardings(
        ref_mesh.lane_mesh(ref_devices(), member_axis=2), ref.state)
    port = port_lockstep.LockstepEngine(JitKvMachine(8), N, 4, device="cpu",
                                        **kw)
    plain = port_lockstep.LockstepEngine(JitKvMachine(8), N, 4,
                                         device="cpu", **kw)
    mesh = port_mesh.shard_engine_state(port, port_mesh_of(2))
    got = port_mesh.state_shardings(mesh, port.state)
    for name in port_lockstep.LaneState._fields:
        g = jax.tree.leaves(getattr(got, name), is_leaf=lambda x:
                            isinstance(x, tuple) and not hasattr(x, "_fields"))
        w = jax.tree.leaves(getattr(want, name))
        assert [tuple(s) for s in g] == [tuple(s.spec) for s in w], name
    assert port.mesh_shape() == "2x4" and len(port._shards) == 4
    for sh in port._shards:
        assert sh.n == 4 and sh.member_bounds == [(0, 2), (2, 4)]
        st = sh.state
        assert st.ring.shape == (4, 32, 4) and st.read_buf.shape[:2] == (4, 3)
        assert st.term.shape == (4,) and st.telem.steps.shape == (4,)
        assert st.match.shape == (4, 2) and st.mac.shape == (4, 2, 8)
        assert [b.shape for b in sh.blocks[0][:2]] == [(4, 2), (4, 2)]
        assert len(sh.blocks) == 1
    assert_same_arrays(state_to_numpy(port.state),
                       state_to_numpy(plain.state), "placed")


def test_shard_ledger_counts_once_and_engine_hooks():
    """``mesh_shard`` is charged once, at shard time; a dispatch adds
    nothing to it.  ``committed_lanes_async`` joins one copy a shard."""
    eng = port_lockstep.LockstepEngine(CounterMachine(), N, P,
                                       ring_capacity=64, max_step_cmds=KC,
                                       device="cpu")
    m0 = dict(devicewatch.WATCH.sites["mesh_shard"])
    port_mesh.shard_engine_state(eng, port_mesh_of(2))
    m1 = dict(devicewatch.WATCH.sites["mesh_shard"])
    assert m1["h2d_events"] > m0["h2d_events"]
    assert m1["h2d_bytes"] > m0["h2d_bytes"]
    eng.uniform_superstep(2, 3)
    eng.uniform_step(1)
    assert dict(devicewatch.WATCH.sites["mesh_shard"]) == m1
    h = eng.committed_lanes_async()
    assert h.is_ready() and np.asarray(h).shape == (N,)
    assert (np.asarray(h) == 7).all() and eng.committed_total() == 7 * N
    assert eng.overview(3)["pipeline"]["mesh_shape"] == "2x4"
    eng.block_until_ready()


# -- the superstep and the driver (tests/test_superstep.py) -----------------

@pytest.mark.parametrize("name", ["counter", "jit_kv"])
def test_mesh_superstep_parity(name):
    """Twin of ``test_mesh_superstep_parity`` (both its K): supersteps
    at K = 1, then 8, with a mid-superstep election on a failed leader,
    then blocks through ``mesh_superstep_driver``; every port engine
    equals the reference's sharded engine after every dispatch."""
    eng = superstep_engines(name)
    rng = np.random.default_rng(300)
    for k in (1, 8):
        for rnd in range(3):
            n_new = rng.integers(0, KC + 1, (k, N)).astype(np.int32)
            pay = payloads(name, rng, k)
            elect = np.zeros((k, N), bool)
            if rnd == 1:
                leader = int(np.asarray(eng.ref.state.leader_slot)[1])
                eng.verb("fail_member", 1, leader)
                elect[min(1, k - 1), 1] = True
            auxes = eng.verb("superstep", n_new, pay, elect_blk=elect)
            want = np.asarray(auxes[0]["committed_lanes"])
            for aux in auxes[1:]:
                assert np.array_equal(np.asarray(aux["committed_lanes"]),
                                      want)
            eng.check(f"{name} k={k} r={rnd}")
        drivers = [ref_mesh.mesh_superstep_driver(eng.ref, eng.ref._mesh)]
        drivers += [port_mesh.mesh_superstep_driver(e) if e._mesh
                    else DispatchAheadDriver(e) for e in eng.ports]
        for _ in range(2):
            nb = rng.integers(0, KC + 1, (k, N)).astype(np.int32)
            pb = payloads(name, rng, k)
            for d in drivers:
                d.submit(nb, pb)
        finals = [np.asarray(d.drain()) for d in drivers]
        assert all(np.array_equal(f, finals[0]) for f in finals)
        eng.check(f"{name} k={k} driver")


def test_driver_stages_blocks_under_mesh_shardings():
    """Twin of ``test_driver_stages_blocks_under_mesh_shardings``: the
    placements name the reference's keys and specs; a driver built with
    them stages each block one piece a lane shard, and the fused run
    equals the reference's; shardings of another mesh are refused."""
    kw = dict(ring_capacity=64, max_step_cmds=KC, write_delay=1)
    ref = ref_lockstep.LockstepEngine(RefCounter(), N, P, donate=False, **kw)
    rsh = ref_mesh.superstep_block_shardings(ref_mesh.shard_engine_state(
        ref, ref_mesh.lane_mesh(ref_devices(), member_axis=1)))
    port = port_lockstep.LockstepEngine(CounterMachine(), N, P,
                                        device="cpu", **kw)
    mesh = port_mesh.shard_engine_state(port, port_mesh_of(1))
    sh = port_mesh.superstep_block_shardings(mesh)
    assert set(sh) == set(rsh) == {"n_new", "payloads", "query", "n_read",
                                   "read_q"}
    assert {k: v.spec for k, v in sh.items()} == \
        {k: tuple(v.spec) for k, v in rsh.items()}
    with pytest.raises(ValueError, match="mesh"):
        DispatchAheadDriver(port, shardings=port_mesh.
                            superstep_block_shardings(port_mesh_of(2)))
    rdrv = ref_lockstep.DispatchAheadDriver(ref, max_in_flight=2,
                                            shardings=rsh)
    drv = DispatchAheadDriver(port, max_in_flight=2, shardings=sh)
    rng = np.random.default_rng(23)
    for _ in range(4):
        nb = np.full((4, N), 2, np.int32)
        pb = payloads("counter", rng, 4)
        rdrv.submit(nb, pb)
        drv.submit(nb, pb)
    staged = drv._staged[0]
    assert all(isinstance(t, LaneParts) for t in staged)
    assert staged[0].bounds() == [(2 * i, 2 * i + 2) for i in range(8)]
    assert staged[1].shape == (4, N, KC, 1)
    assert np.array_equal(np.asarray(drv.drain()), np.asarray(rdrv.drain()))
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       "mesh driver")
    assert port.pipeline_counters["blocks_staged"] == \
        ref.pipeline_counters["blocks_staged"] == 4


# -- elections under the 2-D mesh (test_engine_elections_adversarial.py) --

def test_mesh_sharded_election_fuzz():
    """Twin of ``test_mesh_sharded_election_fuzz``: a fuzzed schedule of
    failures, elections racing traffic, recoveries and follower kills on
    16 lanes x 4 members, the reference over its ``2x4`` mesh; per step
    terms and commits never regress and every engine is equal, and the
    replicas converge at the end."""
    n, p, k = 16, 4, 4
    kw = dict(ring_capacity=128, max_step_cmds=k, write_delay=1)
    eng = Engines(
        lambda: ref_lockstep.LockstepEngine(RefCounter(), n, p,
                                            donate=False, **kw),
        lambda: port_lockstep.LockstepEngine(CounterMachine(), n, p,
                                             device="cpu", **kw),
        ref_members=2, port_members=(2,))
    rng = np.random.default_rng(7)
    down = {lane: set() for lane in range(n)}
    term0 = commit0 = None
    for rnd in range(14):
        leads = np.asarray(eng.ref.state.leader_slot)
        elect = np.zeros((n,), bool)
        for lane in rng.choice(n, 3, replace=False):
            lane = int(lane)
            if rng.random() < 0.5 and len(down[lane]) < (p - 1) // 2:
                victim = int(rng.integers(p))
                if victim not in down[lane]:
                    eng.verb("fail_member", lane, victim)
                    down[lane].add(victim)
                    elect[lane] = victim == int(leads[lane])
            elif down[lane]:
                slot = sorted(down[lane])[0]
                if slot != int(leads[lane]):
                    eng.verb("recover_member", lane, slot)
                    down[lane].discard(slot)
        if rnd % 4 == 3:
            elect |= rng.random(n) < 0.3
        n_new = rng.integers(0, k + 1, (n,)).astype(np.int32)
        pay = rng.integers(1, 9, (n, k, 1)).astype(np.int32)
        eng.verb("step", n_new, pay, elect_mask=elect)
        eng.check(f"round {rnd}")
        st = eng.ports[0].state
        term = st.term.numpy()
        commit = st.commit.numpy().max(axis=1)
        if term0 is not None:
            assert (term >= term0).all() and (commit >= commit0).all()
        term0, commit0 = term, commit
    for lane, slots in down.items():
        for slot in sorted(slots):
            if slot != int(np.asarray(eng.ref.state.leader_slot)[lane]):
                eng.verb("recover_member", lane, slot)
    for _ in range(6):
        eng.verb("step", np.zeros((n,), np.int32),
                 np.zeros((n, k, 1), np.int32))
    eng.check("healed")
    st = eng.ports[0].state                    # the 2x4 port engine
    mac, act = st.mac.numpy(), st.active.numpy()
    ref_val = mac[np.arange(n), np.argmax(act, axis=1)]
    assert not (act & (mac != ref_val[:, None])).any()


# -- the read plane (test_read_plane.py) ------------------------------------

def test_read_oracle_sharded_mesh():
    """Twin of ``test_read_oracle_sharded_mesh`` (``run_read_oracle(2,
    "ttl_kv", mesh=True, rounds=8)``): traffic rounds drained before any
    nemesis, quorum-preserving kills, a majority partition whose leader
    must refuse past its lease, recoveries and elections, a read wave
    every round; every served read equals the model of the whole
    committed history, every engine's replies, watermarks and leaves
    equal, and the healed lanes all serve."""
    from test_read_plane import K as RK
    from test_read_plane import N as RN
    from test_read_plane import P as RP
    from test_read_plane import _TtlModel, _ttl_cmds, _ttl_query
    kw = dict(ring_capacity=64, max_step_cmds=RK, max_step_reads=4,
              lease_ttl=4)
    eng = Engines(
        lambda: ref_lockstep.LockstepEngine(RefTtl(n_keys=8), RN, RP,
                                            donate=False, **kw),
        lambda: port_lockstep.LockstepEngine(TtlKvMachine(n_keys=8), RN,
                                             RP, device="cpu", **kw),
        port_members=(2,), unsharded=False)
    rng = random.Random(2)
    snaps = [_TtlModel(8)]
    down = {lane: set() for lane in range(RN)}
    lanes = np.arange(RN)

    def zeros():
        eng.verb("step", np.zeros((RN,), np.int32),
                 np.zeros((RN, RK, 4), np.int32))

    def drain(limit=96):
        for _ in range(limit):
            st = eng.ports[0].state
            lead = st.leader_slot.numpy()
            tail = st.last_index.numpy()[lanes, lead]
            com = st.commit.numpy()[lanes, lead]
            app = np.where(st.active.numpy(), st.applied.numpy(),
                           np.iinfo(np.int32).max).min(axis=1)
            if (com >= tail).all() and (app >= com).all():
                return
            zeros()
        raise AssertionError("drain did not converge")

    def read_wave(must_refuse=None):
        qs = np.asarray([_ttl_query(rng) for _ in range(RN)], np.int32)
        outs = eng.verb("read_lanes", lanes, qs)
        for got in outs[1:]:
            for g, w in zip(got, outs[0]):
                w = np.asarray(w)
                assert g.dtype == w.dtype and np.array_equal(g, w)
        eng.check("read wave")
        replies, _wm, ok = outs[1]
        if must_refuse is not None:
            assert not ok[must_refuse]
        for lane in np.nonzero(ok)[0]:
            assert tuple(int(x) for x in replies[lane][:2]) == \
                snaps[-1].query(qs[lane])

    for _ in range(8):
        roll = rng.random()
        if roll < 0.45:
            cmds = _ttl_cmds(rng)
            pay = np.zeros((RN, RK, 4), np.int32)
            for j, c in enumerate(cmds):
                pay[:, j] = c
            eng.verb("step", np.full((RN,), RK, np.int32), pay)
            drain()
            for c in cmds:
                m = copy.deepcopy(snaps[-1])
                m.apply(c)
                snaps.append(m)
        elif roll < 0.6:
            leads = np.asarray(eng.ref.state.leader_slot)
            for lane in range(RN):
                if len(down[lane]) >= (RP - 1) // 2:
                    continue
                victim = rng.choice([s for s in range(RP)
                                     if s not in down[lane]])
                eng.verb("fail_member", lane, victim)
                down[lane].add(victim)
                if victim == int(leads[lane]):
                    eng.verb("trigger_election", [lane])
        elif roll < 0.75:
            lane = rng.randrange(RN)
            lead = int(np.asarray(eng.ref.state.leader_slot)[lane])
            cut = [s for s in range(RP) if s != lead and s not in down[lane]]
            for s in cut:
                eng.verb("fail_member", lane, s)
            for _ in range(3 * eng.ref.lease_ttl):
                zeros()
            read_wave(must_refuse=lane)
            for s in cut:
                eng.verb("recover_member", lane, s)
            st = eng.ref.state
            if not np.asarray(st.active)[lane,
                                         int(np.asarray(st.leader_slot)[lane])]:
                eng.verb("trigger_election", [lane])
            drain()
            continue
        elif roll < 0.9:
            leads = np.asarray(eng.ref.state.leader_slot)
            for lane in range(RN):
                if down[lane]:
                    slot = rng.choice(sorted(down[lane]))
                    if slot != int(leads[lane]):
                        eng.verb("recover_member", lane, slot)
                        down[lane].discard(slot)
            drain()
        else:
            healthy = [lane for lane in range(RN) if not down[lane]]
            if healthy:
                eng.verb("trigger_election", healthy)
        read_wave()
    for _ in range(3):
        leads = np.asarray(eng.ref.state.leader_slot)
        for lane in range(RN):
            for slot in sorted(down[lane]):
                if slot != int(leads[lane]):
                    eng.verb("recover_member", lane, slot)
                    down[lane].discard(slot)
        broken = [lane for lane in range(RN) if down[lane]]
        if broken:
            eng.verb("trigger_election", broken)
    drain(128)
    qs = np.asarray([_ttl_query(rng) for _ in range(RN)], np.int32)
    outs = eng.verb("read_lanes", lanes, qs)
    assert outs[1][2].all()


# -- telemetry (test_telemetry.py) ------------------------------------------

TOP = ("top_lanes", "top_commit_lag", "top_apply_lag", "top_stall_steps")
FLOATS = ("elections_requested", "elections_won", "leader_changes",
          "commit_lag_mean", "apply_lag_mean", "committed_total",
          "read_served_total", "read_shed_total", "read_stale_total",
          "read_leased_total")


def assert_snapshots_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "ts":
            continue
        if k in FLOATS:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def test_stalled_lane_detected_sharded_mesh():
    """Twin of ``test_stalled_lane_detected_sharded_mesh``
    (``run_stall_chaos(11, shard=True)``): a lane's quorum broken under
    traffic on 16 lanes; every harvested snapshot of every sharded port
    engine (merged over its shards) equals the reference's, offender
    lane ids exact; the stall is flagged with the victim among the top
    lanes, then clears once healed."""
    n, p, cadence, threshold = 16, 3, 8, 4
    kw = dict(ring_capacity=64, max_step_cmds=4)
    eng = Engines(
        lambda: ref_lockstep.LockstepEngine(RefCounter(), n, p,
                                            donate=False, **kw),
        lambda: port_lockstep.LockstepEngine(CounterMachine(), n, p,
                                             device="cpu", **kw))
    mods = [ref_telemetry] + [port_telemetry] * len(eng.ports)
    samplers = [m.TelemetrySampler(e, cadence_steps=cadence, top_k=4,
                                   stall_threshold=threshold)
                for m, e in zip(mods, eng.all)]
    seen = [[] for _ in samplers]
    for s, lst in zip(samplers, seen):
        s.add_observer(lst.append)
    # every reference sample lands when it starts, as the port's do
    from test_torch_observatory import settle_reference_samples
    settle_reference_samples(samplers[0])
    rng = random.Random(11)
    for _ in range(4):
        eng.verb("uniform_step", 2)
    victim = rng.randrange(n)
    lead = int(np.asarray(eng.ref.state.leader_slot)[victim])
    for slot in range(p):
        if slot != lead:
            eng.verb("fail_member", victim, slot)
    for _ in range(2 * cadence):
        eng.verb("uniform_step", 2)
    snaps = [s.drain() for s in samplers]
    for got in snaps[1:]:
        assert_snapshots_close(got, snaps[0])
    assert snaps[1]["stalled_lanes"] >= 1 and victim in snaps[1]["top_lanes"]
    for slot in range(p):
        if slot != lead:
            eng.verb("recover_member", victim, slot)
    for _ in range(2 * cadence):
        eng.verb("uniform_step", 0)
    snaps = [s.drain() for s in samplers]
    for got in snaps[1:]:
        assert_snapshots_close(got, snaps[0])
    assert snaps[1]["stalled_lanes"] == 0
    assert all(len(lst) == len(seen[0]) for lst in seen)
    for lists in zip(*seen):
        for got in lists[1:]:
            assert_snapshots_close(got, lists[0])
    eng.check("stall chaos")


def test_summary_merge_breaks_ties_to_the_lower_lane():
    """Many equal scores across shards: the merged offenders are the
    reference's ``lax.top_k`` lanes, in its order."""
    n = 32
    rng = np.random.default_rng(5)
    leaves = {f: rng.integers(0, 3, n).astype(np.int32)
              for f in port_lockstep.LaneTelemetry._fields}
    tel = port_lockstep.LaneTelemetry(**{f: torch.from_numpy(v)
                                         for f, v in leaves.items()})
    ref_tel = ref_lockstep.LaneTelemetry(**leaves)
    tc = np.arange(n, dtype=np.int32)
    reads = tuple(np.ones(n, np.int32) for _ in range(4))
    want = {k: np.asarray(v) for k, v in ref_lockstep.telemetry_summary_fn(
        top_k=8, stall_threshold=2)(ref_tel, tc, reads).items()}
    fn = port_lockstep.telemetry_summary_fn(top_k=8, stall_threshold=2)
    parts = []
    for lo in range(0, n, 8):
        sl = slice(lo, lo + 8)
        out = fn(port_lockstep.LaneTelemetry(*(x[sl] for x in tel)),
                 torch.from_numpy(tc[sl]),
                 tuple(torch.from_numpy(r[sl]) for r in reads))
        parts.append((lo, 8, {k: v.numpy() for k, v in out.items()}))
    got = port_lockstep.merge_telemetry_summaries(parts, 8)
    whole = {k: v.numpy() for k, v in fn(
        tel, torch.from_numpy(tc),
        tuple(torch.from_numpy(r) for r in reads)).items()}
    for k in want:
        assert got[k].dtype == want[k].dtype == whole[k].dtype, k
        if k in FLOATS:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)
        else:
            assert np.array_equal(got[k], want[k]), k
            assert np.array_equal(whole[k], want[k]), k


def test_per_device_shard_stats_round_trip_under_mesh(tmp_path):
    """Twin of ``test_per_device_shard_stats_round_trip_under_mesh``: a
    durable engine sharded ``1x8`` with one WAL shard a lane shard; every
    shard's stats reach the exposition and the ring, the mesh stamp
    rides the pipeline overview, and the committed state equals the
    reference's under the same layout."""
    from ra_tpu_torch.telemetry import Observatory, parse_prometheus
    mesh = port_mesh_of(1)
    shards = port_mesh.per_device_wal_shards(mesh)
    assert shards == 8
    rmesh = ref_mesh.lane_mesh(ref_devices(), member_axis=1)
    kw = dict(wal_shards=shards, ring_capacity=256, max_step_cmds=8,
              sync_mode=0)
    ref = ref_open_engine(RefCounter(), str(tmp_path / "r"), 64,
                          donate=False, **kw)
    eng = open_engine(CounterMachine(), str(tmp_path / "p"), 64,
                      device="cpu", **kw)
    try:
        ref_mesh.shard_engine_state(ref, rmesh)
        port_mesh.shard_engine_state(eng, mesh)
        obs = Observatory.for_engine(eng)
        n_new = np.full((64,), 8, np.int32)
        pay = np.ones((64, 8, 1), np.int32)
        for rnd in range(2):
            for _ in range(4):
                for e in (ref, eng):
                    e._dur.flush_all()
                    e.step(n_new, pay)
            for e in (ref, eng):
                e._dur.flush_all()
            snap = obs.snapshot()
        assert len(snap["engine"]["wal"]["shards"]) == 8
        parsed = parse_prometheus(obs.prometheus(snap))
        rates = obs.window_rates()
        for i in range(8):
            assert ("ra_tpu_engine_wal_shards_%d_fsync_p50_ms" % i,
                    "") in parsed
            assert rates.get("engine_wal_shards_%d_writes" % i, 0) > 0, i
        assert snap["engine"]["pipeline"]["mesh_shape"] == "1x8"
        assert eng._dur.shard_layout() == ref._dur.shard_layout() == \
            [[8 * i, 8 * i + 8] for i in range(8)]
        assert eng._dur.counters == ref._dur.counters
        assert_same_arrays(state_to_numpy(eng.state), ref_arrays(ref.state),
                           "durable mesh")
        obs.close()
    finally:
        ref.close()
        eng.close()


# -- the device plane (test_devicewatch.py) ---------------------------------

def test_mesh_driver_loop_steady_state():
    """Twin of ``test_mesh_driver_loop_steady_state``: the placement is
    charged to ``mesh_shard`` once; a ``drive_uniform_window`` over the
    mesh driver adds nothing there, captures nothing, and stages one
    ledger event a staged array a dispatch, as the reference does."""
    sites = {}
    for pkg, mod, lmesh in (("ref", ref_mesh, ref_mesh.lane_mesh(
            ref_devices())), ("port", port_mesh, port_mesh_of(1))):
        if pkg == "ref":
            from ra_tpu.devicewatch import WATCH
            eng = ref_lockstep.LockstepEngine(RefCounter(), 64, 3,
                                              ring_capacity=64,
                                              max_step_cmds=KC, donate=False)
        else:
            WATCH = devicewatch.WATCH
            eng = port_lockstep.LockstepEngine(CounterMachine(), 64, 3,
                                               ring_capacity=64,
                                               max_step_cmds=KC,
                                               device="cpu")
        m0 = dict(WATCH.sites["mesh_shard"])
        mesh = mod.shard_engine_state(eng, lmesh)
        assert WATCH.sites["mesh_shard"]["h2d_events"] > m0["h2d_events"]
        drv = mod.mesh_superstep_driver(eng, mesh, max_in_flight=2)
        nb = np.full((8, 64), 2, np.int32)
        pb = np.ones((8, 64, KC, 1), np.int32)
        for _ in range(3):
            drv.submit(nb, pb)
        drv.drain()
        c0 = (WATCH.counters["compiles"], WATCH.counters["recompiles"])
        m0 = dict(WATCH.sites["mesh_shard"])
        h0 = dict(WATCH.sites["driver_stage"])
        dispatches, inner, _el = mod.drive_uniform_window(drv, nb, pb, 0.2)
        drv.drain()
        assert dispatches > 0 and inner == 8 * dispatches
        assert (WATCH.counters["compiles"],
                WATCH.counters["recompiles"]) == c0
        assert dict(WATCH.sites["mesh_shard"]) == m0
        h1 = WATCH.sites["driver_stage"]
        sites[pkg] = ((h1["h2d_events"] - h0["h2d_events"]) / dispatches,
                      (h1["h2d_bytes"] - h0["h2d_bytes"]) / dispatches)
    assert sites["port"] == sites["ref"] == (2, nb.nbytes + pb.nbytes)


# -- the ingress and wire planes (test_ingress.py, test_wire.py) ------------

def test_session_reconnect_no_duplicate_apply_sharded_mesh():
    """Twin of ``test_session_reconnect_no_duplicate_apply_sharded_mesh``:
    a client killed mid-flight reconnects under the same id and resends
    its unacked tail; seqno dedup applies 1..60 exactly once, on the
    planes of every engine, with equal verdicts, counters and leaves."""
    from ra_tpu.ingress.backpressure import DUP, SLOW
    kw = dict(ring_capacity=64, max_step_cmds=4)
    eng = Engines(
        lambda: ref_lockstep.LockstepEngine(RefCounter(), N, P,
                                            donate=False, **kw),
        lambda: port_lockstep.LockstepEngine(CounterMachine(), N, P,
                                             device="cpu", **kw))
    planes = [RefPlane(eng.ref, superstep_k=2, window_s=0.0, capacity=64)]
    planes += [IngressPlane(e, superstep_k=2, window_s=0.0, capacity=64)
               for e in eng.ports]
    outs = []
    waves = [ref_mesh.ingress_submit_wave] + \
        [port_mesh.ingress_submit_wave] * len(eng.ports)
    for plane, e, wave in zip(planes, eng.all, waves):
        h = plane.connect("acme/alice")
        lane = int(plane.directory.lane[h])
        # the mesh-side pump: one wave submitted and dispatched
        st = wave(plane, np.full(40, h, np.int64), np.arange(1, 41),
                  np.ones((40, 1), np.int32))
        assert (st <= SLOW).all()
        h2 = plane.connect("acme/alice")
        assert h2 == h and plane.directory.epoch[h] == 2
        resend = np.arange(20, 61)
        st2 = plane.submit(np.full(len(resend), h2, np.int64), resend,
                           np.ones((len(resend), 1), np.int32))
        assert (st2[:21] == DUP).all() and (st2[21:] <= SLOW).all()
        plane.settle()
        val = int(np.asarray(e.consistent_read([lane]))[0])
        assert val == 60
        outs.append((lane, st.tolist(), st2.tolist(),
                     dict(plane.counters)))
    assert all(o == outs[0] for o in outs)
    eng.check("reconnect")


def test_ingress_soak_cpu_scaled_mesh_durable(tmp_path):
    """Twin of ``test_ingress_soak_cpu_scaled_mesh_durable``: the ingress
    plane over durable engines sharded ``1x8`` with one WAL shard a lane
    shard (the plane picks up the mesh's staging by itself): duplicate
    resends, credit refusals, tenant deferrals, ring sheds and read
    waves, every dispatch behind a durability barrier; every verdict,
    counter, gauge, reply and leaf equals the reference plane's."""
    import test_torch_ingress as ti
    kw = dict(ring_capacity=128, max_step_cmds=ti.CMDS, max_step_reads=4,
              lease_ttl=4, wal_shards=8, sync_mode=0)
    ref_eng = ref_open_engine(RefCounter(), str(tmp_path / "r"), 24, 3,
                              donate=False, **kw)
    port_eng = open_engine(CounterMachine(), str(tmp_path / "p"), 24, 3,
                           device="cpu", **kw)
    try:
        ref_mesh.shard_engine_state(ref_eng, ref_mesh.lane_mesh(
            ref_devices(), member_axis=1))
        port_mesh.shard_engine_state(port_eng, port_mesh_of(1))
        ref, port, replies = ti._planes(ref_eng, port_eng)
        assert port.driver.shardings and port_eng.mesh_shape() == "1x8"

        def barrier():
            for e in (ref_eng, port_eng):
                e._dur.flush_all()

        for plane in (ref, port):
            for name in ("submit", "drain"):
                def call(*a, _fn=getattr(plane.driver, name), **kw):
                    barrier()
                    return _fn(*a, **kw)
                setattr(plane.driver, name, call)
        ti._drive(ref, port, replies, np.random.default_rng(3), waves=8,
                  barrier=barrier)
        assert port_eng._dur.shard_layout() == [[3 * i, 3 * i + 3]
                                                for i in range(8)]
        assert port_eng._dur.counters == ref_eng._dur.counters
        assert_same_arrays(state_to_numpy(port_eng.state),
                           ref_arrays(ref_eng.state), "ingress mesh")
    finally:
        ref_eng.close()
        port_eng.close()


def test_reconnect_storm_dedup_sharded_mesh():
    """Twin of ``test_reconnect_storm_dedup_sharded_mesh``: 400
    connections of 2 sessions into engines sharded over the mesh, a
    storm kills 40% of them mid-flight; duplicates are absorbed by the
    machine, the lane sums equal the fleet's oracle, and every count, op
    state and leaf equals the reference's."""
    import test_torch_wire as tw
    stacks = {}
    for pkg in ("ref", "port"):
        e = tw.mk_engine(pkg, lanes=32, cmds=8, ring=256, slots=128)
        if pkg == "ref":
            ref_mesh.shard_engine_state(e, ref_mesh.lane_mesh(
                ref_devices(), member_axis=1))
        else:
            port_mesh.shard_engine_state(e, port_mesh_of(2))
        plane = tw.mk_plane(pkg, e)
        stacks[pkg] = (e, plane, tw.mk_listener(pkg, plane, port=None,
                                                max_conns=512,
                                                ring_bytes=4096))
    fleets = {}
    for pkg, (e, plane, lst) in stacks.items():
        fleet = tw.mk_fleet(pkg, lst, 400, sessions_per_conn=2,
                            key="storm", tenants=4, seed=3, max_ops=1 << 16)
        rng = np.random.default_rng(3)
        for w in range(4):
            fleet.new_ops(rng.integers(0, fleet.n_sessions, 600),
                          rng.integers(1, 8, 600).astype(np.int32))
            fleet.send_queued()
            lst.sweep()
            fleet.collect()
            plane.pump(force=True)
            fleet.collect()
            if w == 1:
                assert len(fleet.storm(0.4)) > 0
        tw._until_placed(fleet, lst, plane)
        plane.settle()
        fleet.collect()
        np.testing.assert_array_equal(tw.lane_values(e, np.arange(32)),
                                      fleet.expected_lane_sums(32))
        assert lst.counters["swept_rows"] > fleet.n_ops
        fleets[pkg] = fleet
    assert stacks["port"][0].mesh_shape() == "2x4"
    tw._assert_stacks_equal(stacks, fleets, "mesh storm")
    assert_same_arrays(state_to_numpy(stacks["port"][0].state),
                       ref_arrays(stacks["ref"][0].state), "mesh storm")
    tw._close(stacks)


def test_wire_soak_runs_on_a_mesh(tmp_path):
    """``run_wire_soak(mesh=...)`` over ``1x8`` CPU slots, durable, one
    WAL shard a lane slot: the soak's exactly-once oracle holds (it
    raises otherwise) and its row carries the mesh and the layout."""
    from ra_tpu_torch.wire.soak import run_wire_soak
    res = run_wire_soak(0, conns=64, lanes=16, waves=3, wave_ops=400,
                        cmds=8, superstep_k=2, mesh=port_mesh_of(1),
                        durable_dir=str(tmp_path / "w"), device="cpu")
    assert res["mesh"] == "1x8" and res["wal_shards"] == 8
    assert res["ops"] > 0


# -- durability across mesh shapes ----------------------------------------

def test_durable_dir_reopens_under_any_mesh(tmp_path):
    """A directory written by an engine sharded ``1x8`` (one WAL shard a
    lane shard, an election on the way, no checkpoint: recovery replays
    the RTB2 blocks) recovers unsharded, under ``2x4``, and in the
    reference, all to the state the same history written by an unsharded
    engine recovers to; a checkpoint taken under ``2x4`` restores that
    engine's state unsharded."""
    import shutil
    kw = dict(wal_shards=8, ring_capacity=64, max_step_cmds=KC, sync_mode=0)

    def write(d, mesh):
        eng = open_engine(CounterMachine(), d, N, P, device="cpu", **kw)
        if mesh is not None:
            port_mesh.shard_engine_state(eng, mesh)
        rng = np.random.default_rng(4)
        for i in range(6):
            elect = np.zeros((N,), bool)
            if i == 3:
                eng.fail_member(5, int(eng.state.leader_slot[5]))
                elect[5] = True
            eng.step(rng.integers(0, KC + 1, N).astype(np.int32),
                     payloads("counter", rng, 1)[0], elect_mask=elect)
        eng._dur.flush_all()
        eng.close()

    a, plain_dir = str(tmp_path / "a"), str(tmp_path / "plain")
    write(a, port_mesh_of(1))
    write(plain_dir, None)
    for name in ("b", "c"):
        shutil.copytree(a, str(tmp_path / name))
    want = open_engine(CounterMachine(), plain_dir, N, P, device="cpu", **kw)
    ref = ref_open_engine(RefCounter(), str(tmp_path / "b"), N, P,
                          donate=False, **kw)
    plain = open_engine(CounterMachine(), a, N, P, device="cpu", **kw)
    sharded = open_engine(CounterMachine(), str(tmp_path / "c"), N, P,
                          device="cpu", **kw)
    port_mesh.shard_engine_state(sharded, port_mesh_of(2))
    base = state_to_numpy(want.state)
    assert int(want.state.total_committed.sum()) > 0
    assert_same_arrays(ref_arrays(ref.state), base, "reference recovery")
    for eng in (plain, sharded):
        assert_same_arrays(state_to_numpy(eng.state), base,
                           f"recovered {eng.mesh_shape() or 'unsharded'}")
    for e in (want, ref, plain):
        e.close()
    sharded.step(np.full(N, 2, np.int32), np.ones((N, KC, 1), np.int32))
    sharded.checkpoint()
    ck = state_to_numpy(sharded.state)
    sharded.close()
    again = open_engine(CounterMachine(), str(tmp_path / "c"), N, P,
                        device="cpu", **kw)
    assert_same_arrays(state_to_numpy(again.state), ck, "checkpoint")
    again.close()


# -- the entry twin (__graft_entry__.py) ------------------------------------

def test_entry_matches_reference_entry():
    """``entry()``'s step and example arguments against the reference's
    ``__graft_entry__.entry()``: one call, every leaf equal."""
    import functools

    import __graft_entry__ as graft
    from ra_tpu_torch.entry import entry
    rfn, rargs = graft.entry()
    eng = graft._mk_engine(n_lanes=128, n_members=3)
    # the reference's step takes the read schedule too: an empty one
    rfn = functools.partial(
        rfn, n_read=jax.numpy.zeros((128,), jax.numpy.int32),
        read_q=jax.numpy.zeros((128, eng.read_window, eng.query_width),
                               eng.query_dtype))
    rstate, _raux = jax.jit(rfn)(*rargs)
    fn, args = entry(device="cpu")
    state, aux = fn(*args)
    assert_same_arrays(state_to_numpy(state), ref_arrays(rstate), "entry")
    assert int(state.total_committed.sum()) == 128 * 4


def test_dryrun_multichip_runs_on_cpu_slots():
    """``dryrun_multichip(8)`` on eight CPU slots, the ladder cut to one
    rung: every phase runs and checks itself (it raises otherwise)."""
    from ra_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(8, SLOTS, ladder=[64])
    assert out["mesh"] == {"members": 2, "lanes": 4}
    assert out["committed"] == 64 * 8 and out["kv_committed"] == 64 * 32
    assert [r["mesh"] for r in out["throughput"]] == ["1x8", "2x4"]
    assert out["chaos"][0]["lanes"] == 64


# -- on the card --------------------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from ra_tpu_torch.ops import _build
    _build.build_all()
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.fixture
def one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ra_tpu_torch.ops import _build
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fold_kernels_opt_in_shared_memory_on_each_card(two_cards):
    """Both fold kernels past 48 KB of shared memory a block (a KV cell
    file of 8,192 keys, a FIFO ring of 5,000), on the first card and then
    on the second: the opt-in is kept per device, and each launch equals
    the plain fold."""
    from chip_smoke import fold_operands
    from ra_tpu_torch.core.tree import tree_leaves, tree_map
    from ra_tpu_torch.models import JitFifoMachine
    from ra_tpu_torch.ops import fifo_fold, slot_fold
    cases = ((lambda: JitKvMachine(8192), "kv", slot_fold, False),
             (lambda: JitFifoMachine(5_000, 4, 2), "fifo", fifo_fold, True))
    for dev in two_cards:
        for make, kind, mod, hard in cases:
            m = make()
            rng = np.random.default_rng(len(kind))
            meta, cmds, mask, st = fold_operands(m, kind, 65, 3, 40, rng,
                                                 "cpu", hard=hard)
            want = m.sequential_window_fold(meta, cmds, mask, st)
            before = mod.LAUNCHES
            got = m.in_order_fold(tree_map(lambda x: x.to(dev), meta),
                                  cmds.to(dev), mask.to(dev),
                                  tree_map(lambda x: x.to(dev), st))
            torch.cuda.synchronize(dev)
            assert mod.LAUNCHES == before + 1
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                assert g.device == dev and torch.equal(g.cpu(), w), \
                    (kind, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("member_axis", [1, 2])
def test_sharded_graph_superstep_matches_unsharded_on_card(one_card,
                                                           member_axis):
    """Four slots on one card: the sharded engine's captured graphs (one
    cache a shard) equal an unsharded card engine after every dispatch,
    K = 8, with an election inside a dispatch."""
    kw = dict(ring_capacity=64, max_step_cmds=KC, write_delay=1,
              device=one_card)
    a = port_lockstep.LockstepEngine(JitKvMachine(16), 64, 4, **kw)
    b = port_lockstep.LockstepEngine(JitKvMachine(16), 64, 4, **kw)
    port_mesh.shard_engine_state(b, port_mesh.lane_mesh(
        [one_card] * 4, member_axis=member_axis))
    rng = np.random.default_rng(1)
    for rnd in range(3):
        nb = rng.integers(0, KC + 1, (8, 64)).astype(np.int32)
        pb = payloads("jit_kv", rng, 8, 64)
        elect = np.zeros((8, 64), bool)
        if rnd == 1:
            lead = int(a.state.leader_slot[3])
            a.fail_member(3, lead)
            b.fail_member(3, lead)
            elect[2, 3] = True
        a.superstep(nb, pb, elect_blk=elect)
        b.superstep(nb, pb, elect_blk=elect)
        assert_same_arrays(state_to_numpy(b.state), state_to_numpy(a.state),
                           f"round {rnd}")
    assert all(len(sh.graphs) == 1 for sh in b._shards)


@pytest.mark.cuda
@pytest.mark.parametrize("member_axis", [0, 1, 2])
def test_driver_with_distinct_blocks_matches_supersteps_on_card(one_card,
                                                               member_axis):
    """Distinct blocks through the driver, the host running ahead of the
    card (no sync between submits), unsharded (0) and over four slots of
    one card: the state equals an engine fed the same blocks directly.
    The driver's first copy into a new staging buffer waits for the work
    queued before it on the dispatch stream, from whose pool the buffer
    came."""
    kw = dict(ring_capacity=64, max_step_cmds=KC, device=one_card)
    a = port_lockstep.LockstepEngine(CounterMachine(), 1024, 3, **kw)
    b = port_lockstep.LockstepEngine(CounterMachine(), 1024, 3, **kw)
    if member_axis:
        port_mesh.shard_engine_state(b, port_mesh.lane_mesh(
            [one_card] * 4, member_axis=member_axis))
    rng = np.random.default_rng(13)
    for _ in range(3):
        nb = rng.integers(0, KC + 1, (8, 1024)).astype(np.int32)
        pb = payloads("counter", rng, 8, 1024)
        a.superstep(nb, pb)
        b.superstep(nb, pb)
    drv = DispatchAheadDriver(b)
    for _ in range(12):
        nb = rng.integers(0, KC + 1, (8, 1024)).astype(np.int32)
        pb = payloads("counter", rng, 8, 1024)
        a.superstep(nb, pb)
        drv.submit(nb, pb)
    drv.close()
    assert_same_arrays(state_to_numpy(b.state), state_to_numpy(a.state),
                       "driver")
