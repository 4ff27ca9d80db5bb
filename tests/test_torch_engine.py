"""The port's lockstep engine (device="cpu") against the JAX engine, step
by step: one seeded schedule drives both — commands with ring
backpressure, failures and recovery, elections with ties in
last_written, membership changes, query masks and read batches — and
after every step every LaneState leaf and every aux key must be equal,
dtypes included.  Integer state has no tolerance."""
import jax
import numpy as np
import pytest
import torch

from ra_tpu import metrics as ref_metrics
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch import metrics as port_metrics
from ra_tpu_torch.convert import state_from_numpy, state_to_numpy
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.models import CounterMachine
from ra_tpu_torch.ops import commit_phase, pallas_quorum

CONFIGS = {
    # backpressure: the ring holds just max_step_cmds + 3 entries
    "n64p5_delay1": dict(n=64, p=5, kw=dict(
        write_delay=1, max_step_cmds=8, ring_capacity=11,
        max_step_reads=4, lease_ttl=3, read_timeout=6), ref_kw={}),
    # narrow pipeline credit; the JAX side on the Pallas kernel
    # (interpret mode on the CPU)
    "n48p3_delay0_pallas": dict(n=48, p=3, kw=dict(
        write_delay=0, max_step_cmds=6, ring_capacity=12,
        pipeline_window=4, max_append_batch=3, max_step_reads=2,
        lease_ttl=2, read_timeout=5),
        ref_kw=dict(quorum_impl="pallas")),
    # the commit-phase kernel's widest template: 16 member slots
    "n40p16_delay1": dict(n=40, p=16, kw=dict(
        write_delay=1, max_step_cmds=6, ring_capacity=9,
        max_step_reads=3, lease_ttl=3, read_timeout=6), ref_kw={}),
}


def ref_arrays(state) -> dict:
    """The JAX state as ``<field>:<leaf>`` arrays (the save() key scheme)."""
    return {f"{name}:{j}": np.asarray(x)
            for name in state._fields
            for j, x in enumerate(jax.tree.flatten(getattr(state, name))[0])}


def assert_same_arrays(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.array_equal(g, w), (what, k)


def assert_same(ref, port, ref_aux=None, port_aux=None, what=""):
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       f"state {what}")
    if ref_aux is not None:
        assert_same_arrays({k: v.numpy() for k, v in port_aux.items()},
                           {k: np.asarray(v) for k, v in ref_aux.items()},
                           f"aux {what}")


def make_pair(cfg):
    ref = ref_lockstep.LockstepEngine(RefCounter(), cfg["n"], cfg["p"],
                                      **cfg["kw"], **cfg["ref_kw"])
    port = port_lockstep.LockstepEngine(CounterMachine(), cfg["n"],
                                        cfg["p"], device="cpu", **cfg["kw"])
    return ref, port


def host_verbs(rng, ref, port, failed, now):
    """Failures, recovery, elections and membership changes, chosen from
    the (shared) state so that every verb is one the engine accepts.
    ``failed`` maps each failed (lane, slot) to the step from which it
    may be recovered."""
    N, P = port.n_lanes, port.n_members
    st = port.state
    leader = st.leader_slot.numpy()
    active = st.active.numpy()
    voter = st.voter.numpy()

    def may_heal(lane, slot):
        return failed.get((lane, slot), now + 1) <= now and \
            slot != leader[lane]

    for lane in rng.choice(N, size=3, replace=False):
        lane = int(lane)
        r = rng.random()
        slot = int(rng.integers(P))
        if r < 0.3 and active[lane, slot]:
            for e in (ref, port):
                e.fail_member(lane, slot)
            failed.setdefault((lane, slot), now)
        elif r < 0.45 and may_heal(lane, slot):
            for e in (ref, port):
                e.recover_member(lane, slot)
            del failed[(lane, slot)]
        elif r < 0.55 and slot != leader[lane] and voter[lane, slot] \
                and (lane, slot) not in failed:
            for e in (ref, port):
                e.remove_member(lane, slot)
        elif r < 0.65 and not active[lane, slot] and \
                (lane, slot) not in failed:
            vote = bool(rng.random() < 0.5)
            for e in (ref, port):
                e.add_member(lane, slot, voter=vote)
        elif r < 0.75 and active[lane, slot] and not voter[lane, slot]:
            for e in (ref, port):
                e.promote_member(lane, slot)
    # vectorized recovery of failed non-leaders on a few lanes
    back = [(lane, s) for lane, s in sorted(failed)
            if may_heal(lane, s) and rng.random() < 0.2]
    if back:
        lanes, slots = zip(*back)
        for e in (ref, port):
            e.recover_members(list(lanes), list(slots))
        for k in back:
            del failed[k]
    # cut a lane's leader from its majority for 8 steps: its lease runs
    # out, and reads there are refused, never served stale
    if rng.random() < 0.25:
        lane = int(rng.integers(N))
        for slot in range(P):
            if slot != leader[lane] and active[lane, slot]:
                for e in (ref, port):
                    e.fail_member(lane, slot)
                failed[(lane, slot)] = now + 8
    # fail a leader now and then: the next election must move it
    if rng.random() < 0.3:
        lane = int(rng.integers(N))
        for e in (ref, port):
            e.fail_member(lane, int(leader[lane]))
        failed.setdefault((lane, int(leader[lane])), now)


def drive(cfg, steps, seed):
    rng = np.random.default_rng(seed)
    ref, port = make_pair(cfg)
    N, K, C = port.n_lanes, port.max_step_cmds, port.payload_width
    Kr = port.read_window
    failed = {}
    elections = 0
    assert_same(ref, port, what="init")
    for i in range(steps):
        host_verbs(rng, ref, port, failed, i)
        n_new = rng.integers(0, K + 1, size=N).astype(np.int32)
        n_new[rng.random(N) < 0.3] = K        # fill the ring: backpressure
        payloads = rng.integers(-50, 50, size=(N, K, C)).astype(np.int32)
        kw = {}
        if rng.random() < 0.4:
            kw["elect_mask"] = rng.random(N) < 0.2
            elections += int(kw["elect_mask"].sum())
        if rng.random() < 0.4:
            kw["query_mask"] = rng.random(N) < 0.3
        if rng.random() < 0.5:
            n_read = np.where(rng.random(N) < 0.4,
                              rng.integers(1, Kr + 3, size=N), 0)
            kw["n_read"] = n_read.astype(np.int32)
            kw["read_q"] = rng.integers(0, 9, size=(N, Kr, 1)) \
                .astype(np.int32)
        if rng.random() < 0.1:
            lanes = rng.choice(N, size=4, replace=False)
            for e in (ref, port):
                e.trigger_election(lanes)
            assert_same(ref, port, what=f"election before step {i}")
        ref_aux = ref.step(n_new, payloads, **kw)
        port_aux = port.step(n_new, payloads, **kw)
        assert_same(ref, port, ref_aux, port_aux, what=f"step {i}")
    return ref, port, elections


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference_every_step(name):
    cfg = CONFIGS[name]
    before = pallas_quorum.LAUNCHES, commit_phase.LAUNCHES
    ref, port, elections = drive(cfg, steps=36, seed=len(name))
    # CPU: the plain versions
    assert (pallas_quorum.LAUNCHES, commit_phase.LAUNCHES) == before
    st = port.state
    # the schedule really exercised what it claims to
    assert elections > 0
    assert int(st.telem.elections_won.sum()) > 0
    assert int(st.telem.leader_changes.sum()) > 0
    assert int(st.read_served.sum()) > 0 and int(st.read_shed.sum()) > 0
    assert int(st.read_stale.sum()) > 0
    assert int(st.read_leased.sum()) > 0
    assert int(st.total_committed.sum()) > 0
    assert (~st.active).any() and (~st.voter).any()

    # consistent reads and the read plane answer alike
    healthy = [lane for lane in range(port.n_lanes)
               if st.active[lane].all() and st.voter[lane].all()][:6]
    assert healthy
    got = port.consistent_read(healthy)
    want = ref.consistent_read(healthy)
    assert_same_arrays({"r": got}, {"r": np.asarray(want)}, "consistent")
    assert_same(ref, port, what="after consistent_read")
    q = np.zeros((len(healthy), 1), np.int32)
    for g, w in zip(port.read_lanes(healthy, q), ref.read_lanes(healthy, q)):
        assert_same_arrays({"r": g}, {"r": w}, "read_lanes")
    assert_same(ref, port, what="after read_lanes")
    assert port.committed_total() == ref.committed_total()
    np.testing.assert_array_equal(port.committed_per_lane(),
                                  ref.committed_per_lane())
    assert_same_arrays({"m": port.machine_states()},
                       {"m": ref.machine_states()}, "machine_states")
    for lane in healthy[:2]:
        o_port, o_ref = port.overview(lane), ref.overview(lane)
        for k in ("term", "leader_slot", "last_index", "last_written",
                  "commit", "applied", "active", "total_committed"):
            assert o_port[k] == o_ref[k], k


def test_machine_without_query_kernel_refuses_reads():
    """A machine with no query kernel carries [N,1,1] read fields and
    sheds every read at arrival, in both engines alike."""
    class RefNoQuery(RefCounter):
        query_spec = None

    class NoQuery(CounterMachine):
        query_spec = None

    ref = ref_lockstep.LockstepEngine(RefNoQuery(), 8, 3, max_step_cmds=4)
    port = port_lockstep.LockstepEngine(NoQuery(), 8, 3, max_step_cmds=4,
                                        device="cpu")
    assert port.state.read_buf.shape == (8, 1, 1)
    rng = np.random.default_rng(5)
    for i in range(4):
        n_new = rng.integers(0, 5, size=8).astype(np.int32)
        payloads = rng.integers(0, 9, size=(8, 4, 1)).astype(np.int32)
        n_read = rng.integers(0, 3, size=8).astype(np.int32)
        read_q = np.zeros((8, 1, 1), np.int32)
        kw = dict(n_read=n_read, read_q=read_q)
        assert_same(ref, port, ref.step(n_new, payloads, **kw),
                    port.step(n_new, payloads, **kw), what=f"step {i}")
    assert int(port.state.read_served.sum()) == 0
    assert int(port.state.read_shed.sum()) > 0
    with pytest.raises(ValueError, match="no query kernel"):
        port.read_lanes([0], np.zeros((1, 1), np.int32))


def test_checkpoints_cross_restore(tmp_path):
    cfg = CONFIGS["n64p5_delay1"]
    ref, port, _ = drive(cfg, steps=10, seed=3)
    # JAX archive -> port engine
    ref.save(str(tmp_path / "ref.npz"))
    fresh = port_lockstep.LockstepEngine(CounterMachine(), cfg["n"],
                                         cfg["p"], device="cpu",
                                         **cfg["kw"])
    fresh.restore(str(tmp_path / "ref.npz"))
    assert_same(ref, fresh, what="jax -> port")
    # port archive -> JAX engine
    port.uniform_step(3)
    port.save(str(tmp_path / "port.npz"))
    fresh_ref, _ = make_pair(cfg)
    fresh_ref.restore(str(tmp_path / "port.npz"))
    assert_same(fresh_ref, port, what="port -> jax")
    # both keep stepping alike after the restore
    for e in (fresh_ref, port):
        e.uniform_step(5, payload_value=2)
    assert_same(fresh_ref, port, what="after restore")


def test_restore_defaults_and_refusals():
    port = port_lockstep.LockstepEngine(CounterMachine(), 8, 3,
                                        device="cpu")
    port.uniform_step(4)
    arrays = state_to_numpy(port.state)
    defaults = port_lockstep.CHECKPOINT_FIELD_DEFAULTS
    # a "zeros" field missing from the archive restarts from zero
    partial = {k: v for k, v in arrays.items() if not k.startswith("telem")}
    st = state_from_numpy(partial, port.state, port.device, defaults)
    assert all(int(x.abs().sum()) == 0 for x in st.telem)
    # a "require" field missing, an unknown field, a wrong shape: refused
    with pytest.raises(ValueError, match="required field 'commit'"):
        state_from_numpy({k: v for k, v in arrays.items()
                          if not k.startswith("commit")},
                         port.state, port.device, defaults)
    with pytest.raises(ValueError, match="unknown schema"):
        state_from_numpy({**arrays, "bogus:0": np.zeros(1)}, port.state,
                         port.device, defaults)
    with pytest.raises(ValueError, match="geometry"):
        state_from_numpy({**arrays, "term:0": np.zeros(9, np.int32)},
                         port.state, port.device, defaults)
    with pytest.raises(ValueError, match="dtype"):
        state_from_numpy({**arrays, "term:0": np.zeros(8, np.int64)},
                         port.state, port.device, defaults)


def positional_archives(state, directory) -> dict:
    """The reference ``state`` written as the reference's positional
    archives (``a<i>`` keys over ``jax.tree.flatten(state)``): the full
    one, and the pre-telemetry one without the ``telem`` leaves.
    Returns ``{kind: path}``."""
    flat = [np.asarray(x) for x in jax.tree.flatten(state)[0]]
    n_tel = len(ref_lockstep.LaneTelemetry._fields)
    tel_at = len(jax.tree.flatten(tuple(
        state[:ref_lockstep.LaneState._fields.index("telem")]))[0])
    meta = np.frombuffer(repr({"schema": None}).encode(), dtype=np.uint8)
    paths = {}
    for kind, leaves in (("full", flat),
                         ("pre_telemetry",
                          flat[:tel_at] + flat[tel_at + n_tel:])):
        paths[kind] = str(directory / f"{kind}.npz")
        np.savez(paths[kind], __meta__=meta,
                 **{f"a{i}": a for i, a in enumerate(leaves)})
    return paths


POSITIONAL_KW = dict(ring_capacity=64, max_step_cmds=4)


def positional_pair(n=8, p=3):
    return (ref_lockstep.LockstepEngine(RefCounter(), n, p, donate=False,
                                        **POSITIONAL_KW),
            port_lockstep.LockstepEngine(CounterMachine(), n, p,
                                         device="cpu", **POSITIONAL_KW))


@pytest.mark.parametrize("kind", ["full", "pre_telemetry"])
def test_positional_checkpoints_restore_as_in_reference(tmp_path, kind):
    """The reference's positional archives (``a<i>`` keys, with and
    without the telemetry leaves) restore into both engines alike: every
    leaf equal, dtypes included; the pre-telemetry archive zero-fills
    ``telem``, and both engines step on alike."""
    writer = positional_pair()[0]
    rng = np.random.default_rng(11)
    for _ in range(5):
        writer.step(rng.integers(0, 5, 8).astype(np.int32),
                    rng.integers(-9, 9, (8, 4, 1)).astype(np.int32))
    path = positional_archives(writer.state, tmp_path)[kind]
    ref, port = positional_pair()
    ref.restore(path)
    port.restore(path)
    assert_same(ref, port, what=f"{kind} restored")
    want = ref_arrays(writer.state)
    got = state_to_numpy(port.state)
    for k, w in want.items():
        if kind == "pre_telemetry" and k.startswith("telem:"):
            assert got[k].dtype == w.dtype and not got[k].any(), k
        else:
            assert_same_arrays({k: got[k]}, {k: w}, f"{kind} {k}")
    assert int(writer.state.telem.steps.sum()) == 5 * 8
    for e in (ref, port):
        e.uniform_step(3, payload_value=2)
    assert_same(ref, port, what=f"{kind} after a step")


def test_positional_checkpoint_refusals_match_reference(tmp_path):
    """A positional archive with a leaf count neither full nor
    pre-telemetry, and one of another geometry, are refused by both
    engines with the same message."""
    writer = positional_pair()[0]
    writer.uniform_step(4)
    path = positional_archives(writer.state, tmp_path)["full"]
    with np.load(path) as z:
        short = {k: z[k] for k in z.files}
    del short[f"a{len(short) - 2}"]
    short_path = str(tmp_path / "short.npz")
    np.savez(short_path, **short)
    for archive, engines, match in (
            (short_path, positional_pair(), "leaf count mismatch"),
            (path, positional_pair(n=9), "geometry mismatch")):
        messages = []
        for e in engines:
            with pytest.raises(ValueError, match=match) as exc:
                e.restore(archive)
            messages.append(str(exc.value))
        assert messages[0] == messages[1], messages


def test_registries_match_reference():
    assert port_metrics.ENGINE_PIPELINE_FIELDS == \
        ref_metrics.ENGINE_PIPELINE_FIELDS
    assert port_metrics.TELEMETRY_FIELDS == ref_metrics.TELEMETRY_FIELDS
    for group, fields in port_metrics.FIELD_REGISTRY.items():
        assert ref_metrics.FIELD_REGISTRY[group] == fields
    assert port_lockstep.LaneState._fields == ref_lockstep.LaneState._fields
    assert port_lockstep.LaneTelemetry._fields == \
        ref_lockstep.LaneTelemetry._fields
    assert port_lockstep.CHECKPOINT_FIELD_DEFAULTS == \
        ref_lockstep.CHECKPOINT_FIELD_DEFAULTS


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        e = port_lockstep.LockstepEngine(CounterMachine(), 8, 3)
        assert e.device.type == "cuda"
        assert e.state.term.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_lockstep.LockstepEngine(CounterMachine(), 8, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_lockstep.LockstepEngine(CounterMachine(), 8, 3,
                                         device="cuda")
    e = port_lockstep.LockstepEngine(CounterMachine(), 8, 3, device="cpu")
    assert e.state.commit.device.type == "cpu"


def test_engine_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="ring_capacity"):
        port_lockstep.LockstepEngine(CounterMachine(), 8, 3, device="cpu",
                                     ring_capacity=10, max_step_cmds=8)
    e = port_lockstep.LockstepEngine(CounterMachine(), 8, 3, device="cpu")
    with pytest.raises(ValueError, match="leader"):
        e.recover_member(0, 0)
    with pytest.raises(ValueError, match="leader"):
        e.remove_member(0, 0)
