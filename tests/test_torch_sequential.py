"""The port's lockstep engine (device="cpu") over the order-dependent
machines and the sequential apply path, against the JAX engine, engine
against engine on one seeded schedule:

* a machine with ``supports_batch_apply=False`` (the lane-representative
  fold, ``_apply_sequential``) at P = 3 and 5 with failures, recovery,
  membership changes and elections; and the float-state machine of the
  reference's ``test_scan_machine_float_state_exact`` as a differential;
* ``superstep`` at K = 1, 2, 8 for the KV and FIFO machines (the machine
  parameters of the reference's ``test_superstep.py``), against K single
  steps of the reference (which its own tests hold equal to its
  superstep), consumer ops included so the in-order folds run;
* the read plane over KV and TTL-KV (``read_lanes`` and per-step read
  batches; a partitioned leader refuses once its lease runs out);
* a durable KV engine against the reference's behind a durability
  barrier; FIFO and TTL-KV checkpoints restored across both packages,
  both ways.

Every LaneState leaf and aux key equal (``np.array_equal``, dtypes
included); ``cuda`` cases run on a card and skip here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.core.machine import JitMachine as RefJitMachine
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu.models import JitFifoMachine as RefFifo
from ra_tpu.models import JitKvMachine as RefKv
from ra_tpu.models import TtlKvMachine as RefTtlKv
from ra_tpu_torch.convert import state_to_numpy
from ra_tpu_torch.core.machine import JitMachine
from ra_tpu_torch.engine import DispatchAheadDriver
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.models import CounterMachine, JitFifoMachine, \
    JitKvMachine, TtlKvMachine
from ra_tpu_torch.ops import fifo_fold, slot_fold
from test_torch_engine import assert_same, assert_same_arrays, host_verbs, \
    ref_arrays


class RefSequential(RefCounter):
    supports_batch_apply = False


class Sequential(CounterMachine):
    supports_batch_apply = False


class RefFloatAcc(RefJitMachine):
    """The reference test's float-state machine."""

    command_spec = ("int32", (1,))
    supports_batch_apply = False

    def jit_init(self, n_lanes):
        return jnp.zeros((n_lanes,), jnp.float32)

    def jit_apply(self, meta, command, state):
        new = state + command[..., 0].astype(jnp.float32) * 0.5
        return new, new


class FloatAcc(JitMachine):
    command_spec = ("int32", (1,))
    supports_batch_apply = False

    def jit_init(self, n_lanes, device):
        return torch.zeros((n_lanes,), dtype=torch.float32, device=device)

    def jit_apply(self, meta, command, state):
        new = state + command[..., 0].to(torch.float32) * 0.5
        return new, new


def pair(ref_m, port_m, n, p, **kw):
    return (ref_lockstep.LockstepEngine(ref_m, n, p, **kw),
            port_lockstep.LockstepEngine(port_m, n, p, device="cpu", **kw))


# -- the sequential apply path ------------------------------------------------

@pytest.mark.parametrize("p", [3, 5])
def test_sequential_machine_matches_reference(p):
    """A machine with supports_batch_apply=False through failures,
    recovery, membership changes, elections and commit lag: members that
    apply less than the window land on the right point of the lane's
    trajectory."""
    n = 32
    kw = dict(write_delay=1, max_step_cmds=6, ring_capacity=12,
              apply_window=5, max_step_reads=2, lease_ttl=3, read_timeout=6)
    ref, port = pair(RefSequential(), Sequential(), n, p, **kw)
    rng = np.random.default_rng(p)
    failed = {}
    launches = slot_fold.LAUNCHES, fifo_fold.LAUNCHES
    for i in range(30):
        host_verbs(rng, ref, port, failed, i)
        n_new = rng.integers(0, 7, n).astype(np.int32)
        pay = rng.integers(-50, 50, (n, 6, 1)).astype(np.int32)
        step_kw = {}
        if rng.random() < 0.4:
            step_kw["elect_mask"] = rng.random(n) < 0.2
        if rng.random() < 0.4:
            step_kw["n_read"] = rng.integers(0, 3, n).astype(np.int32)
            step_kw["read_q"] = np.zeros((n, 2, 1), np.int32)
        assert_same(ref, port, ref.step(n_new, pay, **step_kw),
                    port.step(n_new, pay, **step_kw), what=f"step {i}")
    st = port.state
    assert int(st.telem.leader_changes.sum()) > 0
    assert int(st.total_committed.sum()) > 0
    # members apart from their lane's frontier after the run
    assert (st.applied.amax(-1) != st.applied.amin(-1)).any()
    assert (slot_fold.LAUNCHES, fifo_fold.LAUNCHES) == launches


def test_float_state_machine_matches_reference():
    """The lane trajectory is selected by gather for every dtype: float
    state is exact (a one-hot product would 0 * Inf-poison it), and the
    port equals the reference bit for bit."""
    ref, port = pair(RefFloatAcc(), FloatAcc(), 4, 3, ring_capacity=64,
                     max_step_cmds=4, write_delay=1)
    n_new = np.full((4,), 3, np.int32)
    pay = np.ones((4, 4, 1), np.int32)
    for i in range(10):
        if i == 4:
            for e in (ref, port):
                e.fail_member(1, int(np.asarray(ref.state.leader_slot)[1]))
        kw = {"elect_mask": np.arange(4) == 1} if i == 5 else {}
        assert_same(ref, port, ref.step(n_new, pay, **kw),
                    port.step(n_new, pay, **kw), what=f"step {i}")
    st = port.state
    mac, applied = st.mac.numpy(), st.applied.numpy()
    act = st.active.numpy()
    act[1] = False              # lane 1 also applied its new term's noop
    assert mac.dtype == np.float32
    np.testing.assert_array_equal(mac[act], 0.5 * applied[act])


# -- superstep over the order-dependent machines ------------------------------

N, P, KC = 8, 3, 4
SS_KW = dict(ring_capacity=64, max_step_cmds=KC, write_delay=1)


def machine_pair(name):
    if name == "jit_kv":
        return RefKv(n_keys=16), JitKvMachine(n_keys=16)
    return (RefFifo(capacity=16, checkout_slots=4),
            JitFifoMachine(capacity=16, checkout_slots=4))


def payloads(name, rng, k):
    """[k, N, KC, C] command blocks: KV puts/gets/deletes/cas; FIFO
    enqueues and settled dequeues with, on some lanes, the consumer and
    settlement ops that send a window to the in-order fold."""
    if name == "jit_kv":
        p = np.zeros((k, N, KC, 4), np.int32)
        p[..., 0] = rng.integers(1, 5, (k, N, KC))
        p[..., 1] = rng.integers(0, 16, (k, N, KC))
        p[..., 2] = rng.integers(0, 100, (k, N, KC))
        p[..., 3] = rng.integers(-1, 5, (k, N, KC))
        return p
    p = np.zeros((k, N, KC, 3), np.int32)
    p[..., 0] = rng.integers(1, 3, (k, N, KC))
    p[..., 1] = rng.integers(1, 9, (k, N, KC))
    hard = rng.random((k, N)) < 0.3
    p[..., 0] = np.where(hard[..., None], rng.integers(1, 12, (k, N, KC)),
                         p[..., 0])
    p[..., 2] = rng.integers(0, 3, (k, N, KC))
    return p


@pytest.mark.parametrize("name", ["jit_kv", "jit_fifo"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_superstep_machines_match_reference(name, k):
    """K fused rounds of the port equal K single rounds of the reference,
    through traffic, a member failure and a mid-dispatch election."""
    ref_m, port_m = machine_pair(name)
    ref, port = pair(ref_m, port_m, N, P, **SS_KW)
    rng = np.random.default_rng(100 + k)
    for rnd in range(3):
        n_new = rng.integers(0, KC + 1, (k, N)).astype(np.int32)
        pay = payloads(name, rng, k)
        elect = np.zeros((k, N), bool)
        if rnd == 1:
            leader = int(np.asarray(ref.state.leader_slot)[2])
            for e in (ref, port):
                e.fail_member(2, leader)
            elect[min(1, k - 1), 2] = True
        ref_aux = [ref.step(n_new[j], pay[j], elect_mask=elect[j])
                   for j in range(k)]
        port_aux = port.superstep(n_new, pay, elect_blk=elect)
        assert_same(ref, port, what=f"{name} k={k} dispatch {rnd}")
        for key in ref_aux[0]:
            assert_same_arrays(
                {key: port_aux[key].numpy()},
                {key: np.stack([np.asarray(a[key]) for a in ref_aux])},
                f"{name} k={k} dispatch {rnd} aux")
    assert int(port.state.total_committed.sum()) > 0
    assert port.overview(0)["machine"] == type(port_m).__name__


def test_fifo_driver_matches_reference_steps():
    """The dispatch-ahead driver over the FIFO: blocks staged from host
    numpy, the same state as the reference stepped one round at a time."""
    ref_m, port_m = machine_pair("jit_fifo")
    ref, port = pair(ref_m, port_m, N, P, **SS_KW)
    drv = DispatchAheadDriver(port, max_in_flight=2)
    rng = np.random.default_rng(9)
    for d in range(4):
        n_new = rng.integers(0, KC + 1, (4, N)).astype(np.int32)
        pay = payloads("jit_fifo", rng, 4)
        drv.submit(n_new, pay)
        for j in range(4):
            ref.step(n_new[j], pay[j])
    drv.drain()
    drv.close()
    assert_same(ref, port, what="driver")


# -- the read plane over KV and TTL-KV ----------------------------------------

READ_KW = dict(ring_capacity=32, max_step_cmds=4, max_step_reads=4,
               lease_ttl=4)


def read_pair(name):
    if name == "kv":
        return pair(RefKv(n_keys=8), JitKvMachine(n_keys=8), N, P,
                    **READ_KW)
    return pair(RefTtlKv(n_keys=8), TtlKvMachine(n_keys=8), N, P, **READ_KW)


@pytest.mark.parametrize("name", ["kv", "ttl_kv"])
def test_read_plane_matches_reference(name):
    """Writes (TTL puts that expire, watches, deletes), per-step read
    batches and read_lanes: equal state, aux and read replies."""
    ref, port = read_pair(name)
    rng = np.random.default_rng(len(name))
    for i in range(14):
        pay = np.zeros((N, 4, 4), np.int32)
        pay[..., 0] = rng.integers(1, 5, (N, 4))
        pay[..., 1] = rng.integers(-1, 9, (N, 4))
        pay[..., 2] = rng.integers(0, 50, (N, 4))
        pay[..., 3] = rng.integers(-1, 6, (N, 4))
        n_new = rng.integers(0, 5, N).astype(np.int32)
        kw = {}
        if i % 3 == 1:
            kw["n_read"] = rng.integers(0, 5, N).astype(np.int32)
            kw["read_q"] = np.stack([rng.integers(0, 3, (N, 4)),
                                     rng.integers(-1, 9, (N, 4))],
                                    -1).astype(np.int32)
        assert_same(ref, port, ref.step(n_new, pay, **kw),
                    port.step(n_new, pay, **kw), what=f"{name} step {i}")
    q = np.stack([np.arange(N) % 3, np.arange(N) % 9 - 1],
                 -1).astype(np.int32)
    for got, want in zip(port.read_lanes(np.arange(N), q),
                         ref.read_lanes(np.arange(N), q)):
        assert_same_arrays({"r": got}, {"r": np.asarray(want)}, "read")
    assert_same(ref, port, what=f"{name} after read_lanes")
    assert int(port.state.read_served.sum()) > 0


def test_partitioned_leader_refuses_after_lease_expiry():
    """TTL-KV: a leader cut from its majority stops serving once its lease
    runs out, and serves again after healing, in both engines alike."""
    ref, port = read_pair("ttl_kv")
    pay = np.zeros((N, 4, 4), np.int32)
    pay[:, 0] = (1, 1, 9, 0)
    for e in (ref, port):
        e.step(np.full((N,), 1, np.int32), pay)
        for _ in range(4):
            e.step(np.zeros(N, np.int32), pay)
    lead = int(np.asarray(ref.state.leader_slot)[0])
    for s in range(P):
        if s != lead:
            for e in (ref, port):
                e.fail_member(0, s)
    for e in (ref, port):
        for _ in range(3 * e.lease_ttl):
            e.step(np.zeros(N, np.int32), pay)
    q = np.asarray([[1, 1]], np.int32)
    got, want = port.read_lanes([0], q), ref.read_lanes([0], q)
    assert not got[2][0]
    for g, w in zip(got, want):
        assert_same_arrays({"r": g}, {"r": np.asarray(w)}, "refused")
    for s in range(P):
        if s != lead:
            for e in (ref, port):
                e.recover_member(0, s)
    for g, w in zip(port.read_lanes([0], q), ref.read_lanes([0], q)):
        assert_same_arrays({"r": g}, {"r": np.asarray(w)}, "healed")
    assert_same(ref, port, what="after heal")


# -- durable KV, FIFO checkpoints ---------------------------------------------

def test_durable_kv_matches_reference_behind_barrier(tmp_path):
    kw = dict(sync_mode=0, ring_capacity=32, max_step_cmds=4,
              wal_shards=2, max_pending=16)
    ref = ref_open_engine(RefKv(n_keys=16), str(tmp_path / "ref"), N, P,
                          **kw)
    port = open_engine(JitKvMachine(n_keys=16), str(tmp_path / "port"), N,
                       P, device="cpu", **kw)
    rng = np.random.default_rng(11)
    for d in range(6):
        n_new = rng.integers(0, 5, (2, N)).astype(np.int32)
        pay = payloads("jit_kv", rng, 2)
        for e in (ref, port):
            e._dur.flush_all()
        if d % 2:
            ref.superstep(n_new, pay)
            port.superstep(n_new, pay)
        else:
            for j in range(2):
                for e in (ref, port):
                    e._dur.flush_all()
                ref.step(n_new[j], pay[j])
                port.step(n_new[j], pay[j])
        for e in (ref, port):
            e._dur.flush_all()
        assert_same_arrays(state_to_numpy(port.state),
                           ref_arrays(ref.state), f"durable dispatch {d}")
        assert port._dur.counters == ref._dur.counters
    assert port.committed_total() > 0
    ref.close()
    port.close()
    # each recovers the other's directory to the same state
    a = open_engine(JitKvMachine(n_keys=16), str(tmp_path / "ref"), N, P,
                    device="cpu", **kw)
    b = ref_open_engine(RefKv(n_keys=16), str(tmp_path / "port"), N, P,
                        **kw)
    assert_same_arrays(state_to_numpy(a.state), ref_arrays(b.state),
                       "cross-recovered")
    a.close()
    b.close()


def checkpoint_pair(name):
    if name == "ttl_kv":
        return RefTtlKv(n_keys=16), TtlKvMachine(n_keys=16)
    return machine_pair(name)


@pytest.mark.parametrize("name", ["jit_fifo", "ttl_kv"])
def test_checkpoint_restores_across_packages(tmp_path, name):
    """A FIFO or TTL-KV engine's schema-named archive (its dict machine
    state in sorted-key leaves) restores into the other package's engine,
    both ways, and both keep stepping alike."""
    kind = "jit_kv" if name == "ttl_kv" else name
    ref, port = pair(*checkpoint_pair(name), N, P, **SS_KW)
    rng = np.random.default_rng(5)
    for _ in range(6):
        n_new = rng.integers(0, KC + 1, N).astype(np.int32)
        pay = payloads(kind, rng, 1)[0]
        ref.step(n_new, pay)
        port.step(n_new, pay)
    ref.save(str(tmp_path / "ref.npz"))
    port.save(str(tmp_path / "port.npz"))
    fresh_ref, fresh_port = pair(*checkpoint_pair(name), N, P, **SS_KW)
    fresh_port.restore(str(tmp_path / "ref.npz"))
    fresh_ref.restore(str(tmp_path / "port.npz"))
    assert_same(ref, fresh_port, what="jax -> port")
    assert_same(fresh_ref, port, what="port -> jax")
    assert sorted(fresh_port.state.mac) == sorted(jax.tree.map(
        np.asarray, ref.state.mac))
    for _ in range(3):
        n_new = rng.integers(0, KC + 1, N).astype(np.int32)
        pay = payloads(kind, rng, 1)[0]
        for e in (fresh_ref, fresh_port):
            e.step(n_new, pay)
    assert_same(fresh_ref, fresh_port, what="after restore")


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _fifo_blocks(rng, k, n):
    """Consumer-mix blocks: (enqueue, enqueue, dequeue-unsettled, settle)
    repeats, the settles naming ids the lane has not handed out (so they
    are no-ops) and every eighth a return."""
    pay = np.zeros((k, n, 8, 3), np.int32)
    pay[..., 0] = np.tile([1, 1, 3, 4], 2)
    pay[..., 1] = rng.integers(0, 100, (k, n, 8))
    pay[:, :, 7, 0] = 5
    return np.full((k, n), 8, np.int32), pay


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jit_kv", "jit_fifo", "ttl_kv"])
def test_driver_loop_has_no_host_sync_on_card(cuda_device, name):
    """A driver loop on the card through the in-order fold kernels, under
    ``torch.cuda.set_sync_debug_mode("error")``: no step or superstep
    synchronises with the host, and the graph launches the fold kernel
    once an inner step."""
    n, k = 256, 4
    if name == "jit_fifo":
        m, mod = JitFifoMachine(capacity=32, checkout_slots=4), fifo_fold
    elif name == "jit_kv":
        m, mod = JitKvMachine(n_keys=16), slot_fold
    else:
        m, mod = TtlKvMachine(n_keys=16), slot_fold
    eng = port_lockstep.LockstepEngine(m, n, 3, ring_capacity=64,
                                       max_step_cmds=8, device=cuda_device)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    rng = np.random.default_rng(0)
    if name == "jit_fifo":
        blocks = [_fifo_blocks(rng, k, n) for _ in range(6)]
    else:
        pay = np.zeros((k, n, 8, 4), np.int32)
        pay[..., 0] = 4 if name == "jit_kv" else 1          # cas / put
        pay[..., 1] = rng.integers(0, 16, (k, n, 8))
        blocks = [(np.full((k, n), 8, np.int32), pay)] * 6
    drv.submit(*blocks[0])          # capture outside the checked window
    drv.drain()
    before = mod.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks[1:]:
            drv.submit(*b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    drv.drain()
    drv.close()
    assert mod.LAUNCHES == before     # replays launch nothing on the host
    g = next(iter(eng._graphs._graphs.values()))
    assert g.captured_launches["commit_phase"] == k
    assert g.captured_launches[mod.__name__.rsplit(".", 1)[1]] == k
