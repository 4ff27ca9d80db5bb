"""The port's durable lane engine against the JAX engine's.

* ``_step(durable=True)`` and ``_superstep(durable=True)`` on one seeded
  schedule with a scripted ``confirm_upto`` (confirms that lag, jump
  past the tail or fall below it; elections with ties and won elections
  whose confirm exceeds the new leader's written tail; lanes with no,
  partial and full accepts): the port on the CPU against the
  reference's jitted function, every LaneState leaf and aux key
  (``flat_rows`` and ``row_csum`` included) equal after every step.
* The block codec, ``_assemble_blocks`` and ``_final_logs``.
* Engine against engine: ``open_engine(..., device="cpu")`` against the
  reference's ``open_engine`` with a durability barrier before each
  dispatch, and recovery of one package's data directory by the other.
* The reference's durable behaviour tests, ported: commits gate on the
  confirm, freeze when the WAL dies, a checkpoint prunes the WAL,
  recovery revives a failed member, kill -9 loses no reported commit.

Integer state has no tolerance: ``np.array_equal``, dtypes included.
The ``cuda`` cases run the durable engine on the card and skip here."""
import functools
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from ra_tpu.engine import durable as ref_durable
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.log.wal import scan_wal_file as ref_scan_wal_file
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch import devicewatch
from ra_tpu_torch.convert import state_to_numpy
from ra_tpu_torch.engine import DispatchAheadDriver, LockstepEngine
from ra_tpu_torch.engine import durable as port_durable
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.log.wal import WalDown
from ra_tpu_torch.metrics import ENGINE_WAL_FIELDS
from ra_tpu_torch.models import CounterMachine
from ra_tpu_torch.ops import commit_phase
from test_torch_engine import assert_same_arrays, ref_arrays

N, P, K = 16, 3, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- _step / _superstep, durable ---------------------------------------------

STEP_KW = dict(ring_capacity=14, max_step_cmds=6, write_delay=0,
               max_step_reads=3, lease_ttl=3, read_timeout=6)


def function_pair(n, p):
    """The two engines' initial states and their durable step/superstep
    functions (the reference's jitted)."""
    ref = ref_lockstep.LockstepEngine(RefCounter(), n, p, **STEP_KW)
    port = LockstepEngine(CounterMachine(), n, p, device="cpu", **STEP_KW)
    fns = {
        "ref_step": jax.jit(functools.partial(
            ref_lockstep._step, durable=True, **ref._step_kwargs)),
        "ref_sstep": jax.jit(functools.partial(
            ref_lockstep._superstep, durable=True, **ref._step_kwargs)),
        "port_step": functools.partial(
            port_lockstep._step, durable=True, **port._step_kwargs),
        "port_sstep": functools.partial(
            port_lockstep._superstep, durable=True, **port._step_kwargs),
    }
    return ref.state, port.state, fns


def scripted_confirm(rng, state_np, prev):
    """Per lane one of: the leader's tail lagged by 0-3, a jump past the
    tail, 0 (below every entry), or last round's horizon."""
    n = state_np["leader_slot:0"].shape[0]
    tail = state_np["last_index:0"][np.arange(n), state_np["leader_slot:0"]]
    pick = rng.integers(0, 4, n)
    confirm = np.select(
        [pick == 0, pick == 1, pick == 2],
        [tail - rng.integers(0, 4, n), tail + rng.integers(1, 6, n),
         np.zeros(n, np.int64)], prev)
    return confirm.astype(np.int32)


def schedule(rng, n, p, kc, step):
    """n_new (no, partial and full accepts), payloads, a fail mask for the
    first rounds, an elect mask and the read inputs."""
    n_new = rng.integers(0, kc + 1, n).astype(np.int32)
    n_new[rng.random(n) < 0.3] = kc            # fill the ring
    n_new[rng.random(n) < 0.15] = 0
    pay = rng.integers(-50, 50, (n, kc, 1)).astype(np.int32)
    fail = (rng.random((n, p)) < 0.04) if step < 6 else np.zeros((n, p),
                                                                  bool)
    elect = rng.random(n) < 0.25
    query = rng.random(n) < 0.2
    n_read = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n),
                      0).astype(np.int32)
    read_q = rng.integers(0, 9, (n, 3, 1)).astype(np.int32)
    return n_new, pay, fail, elect, query, n_read, read_q


def assert_step_equal(ref_state, port_state, ref_aux, port_aux, what):
    assert_same_arrays(state_to_numpy(port_state), ref_arrays(ref_state),
                       f"state {what}")
    assert {"flat_rows", "row_csum"} <= set(port_aux)
    assert_same_arrays({k: v.numpy() for k, v in port_aux.items()},
                       {k: np.asarray(v) for k, v in ref_aux.items()},
                       f"aux {what}")


@pytest.mark.parametrize("n,p", [(48, 3), (40, 5), (24, 16)])
def test_durable_step_matches_reference(n, p):
    ref_st, port_st, fns = function_pair(n, p)
    rng = np.random.default_rng(n * 100 + p)
    kc = STEP_KW["max_step_cmds"]
    confirm = np.zeros(n, np.int32)
    seen = {"ties": 0, "clamped": 0, "partial": 0, "none": 0, "full": 0}
    for i in range(14):
        before = state_to_numpy(port_st)
        confirm = scripted_confirm(rng, before, confirm)
        n_new, pay, fail, elect, query, n_read, read_q = \
            schedule(rng, n, p, kc, i)
        ref_st, ref_aux = fns["ref_step"](
            ref_st, n_new, pay, fail, elect, confirm, query, n_read, read_q)
        port_st, port_aux = fns["port_step"](
            port_st, *(torch.from_numpy(x) for x in (
                n_new, pay, fail, elect, confirm, query, n_read, read_q)))
        assert_step_equal(ref_st, port_st, ref_aux, port_aux, f"step {i}")
        # what the schedule exercised
        won = port_st.term.numpy() > before["term:0"]
        written = np.where(before["active:0"] & before["voter:0"],
                           before["last_written:0"], -1)
        top = written.max(axis=1)
        seen["ties"] += int((elect & ((written == top[:, None]).sum(1) > 1))
                            .sum())
        seen["clamped"] += int((won & (confirm > top)).sum())
        n_acc = port_aux["n_acc"].numpy()
        seen["none"] += int((n_acc == 0).sum())
        seen["partial"] += int(((n_acc > 0) & (n_acc < n_new)).sum())
        seen["full"] += int(((n_acc > 0) & (n_acc == n_new)).sum())
    assert all(seen.values()), seen
    assert int(port_st.total_committed.sum()) > 0


@pytest.mark.parametrize("k", [1, 4])
def test_durable_superstep_matches_reference(k):
    n, p = 40, 5
    ref_st, port_st, fns = function_pair(n, p)
    rng = np.random.default_rng(300 + k)
    kc = STEP_KW["max_step_cmds"]
    confirm = np.zeros(n, np.int32)
    for d in range(5):
        confirm = scripted_confirm(rng, state_to_numpy(port_st), confirm)
        steps = [schedule(rng, n, p, kc, d * k + j) for j in range(k)]
        blk = [np.stack([s[i] for s in steps]) for i in range(7)]
        n_new, pay, fail, elect, query, n_read, read_q = blk
        fail = fail[0]
        ref_st, ref_aux = fns["ref_sstep"](
            ref_st, n_new, pay, fail, elect, confirm, query, n_read, read_q)
        port_st, port_aux = fns["port_sstep"](
            port_st, *(torch.from_numpy(x) for x in (
                n_new, pay, fail, elect, confirm, query, n_read, read_q)))
        assert port_aux["flat_rows"].shape == (k, n * kc, 1)
        assert port_aux["row_csum"].shape == (k, n)
        assert_step_equal(ref_st, port_st, ref_aux, port_aux,
                          f"k={k} dispatch {d}")
    assert int(port_st.telem.elections_won.sum()) > 0


def test_compaction_pads_like_repeat():
    """Rows past the accepted total are zero, and the source lanes pad
    with the last lane id as ``jnp.repeat(total_repeat_length=)`` does."""
    n_acc = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    pay = torch.arange(4 * 3, dtype=torch.int32).reshape(4, 3, 1) + 1
    flat, csum = port_lockstep._compact_accepted(pay, n_acc)
    assert csum.dtype == torch.int32 and csum.tolist() == [2, 2, 3, 3]
    assert flat[:, 0].tolist() == [1, 2, 7] + [0] * 9
    empty, csum0 = port_lockstep._compact_accepted(
        torch.zeros((0, 3, 1), dtype=torch.int32),
        torch.zeros((0,), dtype=torch.int32))
    assert empty.shape == (0, 1) and csum0.shape == (0,)


# -- the block codec and the recovery merge ----------------------------------

def test_block_codec_byte_equal_both_ways():
    rng = np.random.default_rng(0)
    for lane_lo in (0, 8):
        hi = rng.integers(1, 100, N).astype(np.int32)
        n_acc = rng.integers(0, K, N).astype(np.int32)
        n_app = n_acc + rng.integers(0, 2, N).astype(np.int32)
        ph = rng.integers(0, 1000, (N, K, 1)).astype(np.int32)
        flat = ph[np.arange(K)[None, :] < n_acc[:, None]]
        got = port_durable.encode_block_flat(hi, n_app, n_acc, flat,
                                             lane_lo=lane_lo)
        want = ref_durable.encode_block_flat(hi, n_app, n_acc, flat,
                                             lane_lo=lane_lo)
        assert got == want
        assert got[:4] == (b"RTB2" if lane_lo else b"RTB1")
        if not lane_lo:
            legacy = port_durable.encode_block(hi, n_app, n_acc, ph)
            assert legacy == ref_durable.encode_block(hi, n_app, n_acc, ph)
            assert legacy == got
        for blk in (got, want):
            a = port_durable.decode_block(blk)
            b = ref_durable.decode_block(blk)
            assert a[0] == b[0] == lane_lo
            assert_same_arrays(dict(enumerate(a[1:])),
                               dict(enumerate(b[1:])), "decode")
    with pytest.raises(ValueError, match="magic"):
        port_durable.decode_block(b"XXXX" + bytes(40))


def seeded_pieces(rng):
    """Step pieces of two half-lane slices: appends, one election
    truncation, a step where one slice is missing, and a gapped piece."""
    half = N // 2
    tail = np.zeros(N, np.int32)
    pieces = {}
    for s in range(1, 7):
        ps = []
        for lo in (0, half):
            if s == 4 and lo == half:
                continue                              # slice missing
            n_acc = rng.integers(0, K, half).astype(np.int32)
            noop = np.zeros(half, np.int32)
            base = tail[lo:lo + half].copy()
            if s == 3:
                base[:3] -= 2                         # truncation
                noop[:3] = 1
            if s == 5 and lo == 0:
                base[5] += 4                          # gap: skipped
            n_app = n_acc + noop
            hi = base + n_app
            rows = rng.integers(1, 99, (half, K, 1)).astype(np.int32)
            blk = ref_durable.encode_block_flat(
                hi, n_app, n_acc,
                rows[np.arange(K)[None, :] < n_acc[:, None]], lane_lo=lo)
            ps.append(blk)
            ok = hi - n_app <= tail[lo:lo + half]
            tail[lo:lo + half] = np.where(ok, hi, tail[lo:lo + half])
        pieces[s] = ps
    return pieces


def test_assemble_blocks_and_final_logs_match_reference():
    raw = seeded_pieces(np.random.default_rng(4))
    ckpt_tail = np.zeros(N, np.int32)
    got = port_durable._assemble_blocks(
        {s: [port_durable.decode_block(b) for b in bs]
         for s, bs in raw.items()}, N, ckpt_tail)
    want = ref_durable._assemble_blocks(
        {s: [ref_durable.decode_block(b) for b in bs]
         for s, bs in raw.items()}, N, ckpt_tail)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert_same_arrays(dict(enumerate(g[1:])), dict(enumerate(w[1:])),
                           f"block {g[0]}")
    for tail in (ckpt_tail, np.full(N, 3, np.int32)):
        a = port_durable._final_logs(got, tail)
        b = ref_durable._final_logs(want, tail)
        assert_same_arrays(dict(enumerate(a[0])), dict(enumerate(b[0])),
                           "surv")
        assert_same_arrays({"t": a[1], "h": a[2]}, {"t": b[1], "h": b[2]},
                           "tails")
    assert port_durable._final_logs([], ckpt_tail)[0] == []


# -- engine against engine ---------------------------------------------------

ENG_KW = dict(sync_mode=0, ring_capacity=64, max_step_cmds=K)


def open_pair(tmp_path, **kw):
    kw = {**ENG_KW, **kw}
    ref = ref_open_engine(RefCounter(), str(tmp_path / "ref"), N, P, **kw)
    port = open_engine(CounterMachine(), str(tmp_path / "port"), N, P,
                       device="cpu", **kw)
    return ref, port


def wal_records(data_dir, scan):
    """Every engine block on disk, decoded: {(shard dir, step): block}."""
    out = {}
    for root, _dirs, names in os.walk(data_dir):
        tables: dict = {}
        for name in sorted(n for n in names if n.endswith(".wal")):
            scan(os.path.join(root, name), tables)
        for s, (_term, blk) in tables.get("__engine__", {}).items():
            out[(os.path.relpath(root, data_dir), s)] = \
                port_durable.decode_block(blk)
    return out


def assert_records_equal(ref_dir, port_dir):
    got = wal_records(port_dir, ref_scan_wal_file)
    want = wal_records(ref_dir, ref_scan_wal_file)
    assert sorted(got) == sorted(want) and got
    for key in want:
        assert got[key][0] == want[key][0]
        assert_same_arrays(dict(enumerate(got[key][1:])),
                           dict(enumerate(want[key][1:])), f"wal {key}")


def barrier(*engines):
    for e in engines:
        e._dur.flush_all()


def assert_engines_equal(ref, port, what):
    barrier(ref, port)
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       f"state {what}")
    assert port._dur.counters == ref._dur.counters, what
    assert port._dur.step_seq == ref._dur.step_seq
    np.testing.assert_array_equal(port._dur.confirm_upto,
                                  ref._dur.confirm_upto)


@pytest.mark.parametrize("shards", [1, 4])
def test_engine_with_barrier_matches_reference(tmp_path, shards):
    """Same confirms on both sides (a barrier before each dispatch): the
    states, confirm horizons, counters and WAL records are equal, over
    single steps, supersteps and elections inside them."""
    from ra_tpu.devicewatch import WATCH as REF_WATCH
    ref, port = open_pair(tmp_path, wal_shards=shards, max_pending=32)
    r0 = dict(REF_WATCH.sites["wal_readback"])
    p0 = dict(devicewatch.WATCH.sites["wal_readback"])
    rng = np.random.default_rng(shards)
    for d in range(8):
        n_new = rng.integers(0, K + 1, (4, N)).astype(np.int32)
        pay = rng.integers(-9, 10, (4, N, K, 1)).astype(np.int32)
        elect = np.zeros((4, N), bool)
        if d % 3 == 2:
            elect[2, rng.choice(N, 4, replace=False)] = True
        for e in (ref, port):
            if d == 4:
                e.fail_member(1, int(np.asarray(e.state.leader_slot)[1]))
        barrier(ref, port)
        if d % 2:
            ref.superstep(n_new, pay, elect_blk=elect)
            port.superstep(n_new, pay, elect_blk=elect)
        else:
            for j in range(4):
                barrier(ref, port)
                ref.step(n_new[j], pay[j], elect_mask=elect[j])
                port.step(n_new[j], pay[j], elect_mask=elect[j])
                assert_engines_equal(ref, port, f"dispatch {d} step {j}")
        assert_engines_equal(ref, port, f"dispatch {d}")
    barrier(ref, port)
    assert port.committed_total() > 0
    # the transfer ledger's WAL readback line equals the reference's
    got = {k: v - p0[k] for k, v in devicewatch.WATCH.sites[
        "wal_readback"].items()}
    want = {k: v - r0[k] for k, v in REF_WATCH.sites["wal_readback"].items()}
    assert got == want and got["d2h_bytes"] > 0
    assert set(port.overview(0)["wal"]["engine"]) >= set(ENGINE_WAL_FIELDS)
    ov = port._dur.wal_overview()
    assert len(ov["shards"]) == shards
    assert ov["engine"]["readback_bytes"] < \
        ov["engine"]["readback_bytes_full"]
    ref.close()
    port.close()
    assert_records_equal(str(tmp_path / "ref"), str(tmp_path / "port"))


def write_history(make, data_dir, shards):
    """A durable run with a checkpoint, an election truncation after it
    and a WAL tail; returns the engine's state before close."""
    eng = make(data_dir, wal_shards=shards)
    rng = np.random.default_rng(9)
    for _ in range(5):
        eng.step(rng.integers(0, K + 1, N).astype(np.int32),
                 rng.integers(1, 9, (N, K, 1)).astype(np.int32))
    eng.checkpoint()
    for _ in range(3):
        eng.step(np.full(N, K, np.int32), np.ones((N, K, 1), np.int32))
    # fail two leaders and elect: their unconfirmed tails are truncated
    for lane in (0, 5):
        eng.fail_member(lane, int(np.asarray(eng.state.leader_slot)[lane]))
    eng.trigger_election([0, 5])
    for _ in range(4):
        eng.superstep(np.full((2, N), 3, np.int32),
                      np.full((2, N, K, 1), 2, np.int32))
    eng.close()


def make_ref(path, **kw):
    return ref_open_engine(RefCounter(), str(path), N, P,
                           **{**ENG_KW, **kw})


def make_port(path, **kw):
    return open_engine(CounterMachine(), str(path), N, P, device="cpu",
                       **{**ENG_KW, **kw})


@pytest.mark.parametrize("writer,shards", [("ref", (1, 4)),
                                           ("port", (1, 4)),
                                           ("port", (4, 1))])
def test_cross_recovery(tmp_path, writer, shards):
    """A data directory written by one package recovers in the other to
    the state the writer's own package recovers from a copy of it."""
    a, b = tmp_path / "a", tmp_path / "b"
    write_history(make_ref if writer == "ref" else make_port, a, shards[0])
    shutil.copytree(a, b)
    port = make_port(a, wal_shards=shards[1])
    ref = make_ref(b, wal_shards=shards[1])
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       f"{writer} dir recovered")
    assert int(port.state.telem.leader_changes.sum()) >= 0
    np.testing.assert_array_equal(port._dur.confirm_upto,
                                  ref._dur.confirm_upto)
    assert port._dur.step_seq == ref._dur.step_seq > 0
    # both keep going alike
    for e in (ref, port):
        e._dur.flush_all()
        e.step(np.full(N, 2, np.int32), np.ones((N, K, 1), np.int32))
        e._dur.flush_all()
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       "after a step")
    ref.close()
    port.close()


@pytest.mark.parametrize("kind", ["full", "pre_telemetry"])
def test_positional_checkpoint_dir_reopens_in_both(tmp_path, kind):
    """A durable directory whose ``ckpt.npz`` is a positional archive of
    the reference's older engines (``a<i>`` keys, with or without the
    telemetry leaves) reopens through ``open_engine`` in both packages
    to the same state, leaf for leaf, and both step on alike."""
    from test_torch_engine import positional_archives
    a = tmp_path / "a"
    eng = make_ref(a, wal_shards=2)
    rng = np.random.default_rng(12)
    for _ in range(6):
        eng.step(rng.integers(0, K + 1, N).astype(np.int32),
                 rng.integers(1, 9, (N, K, 1)).astype(np.int32))
    eng.checkpoint()
    for _ in range(3):
        eng.step(np.full(N, 4, np.int32), np.ones((N, K, 1), np.int32))
    eng._dur.flush_all()
    state = eng.state
    eng.close()
    ckpt = a / "ckpt.npz"
    with np.load(str(ckpt)) as z:
        checkpointed = {k: z[k] for k in z.files if k != "__meta__"}
    ckpt_state = ref_lockstep.LaneState(*(
        jax.tree.unflatten(jax.tree.structure(getattr(state, name)), [
            checkpointed[f"{name}:{j}"] for j in range(
                len(jax.tree.leaves(getattr(state, name))))])
        for name in ref_lockstep.LaneState._fields))
    os.replace(positional_archives(ckpt_state, tmp_path)[kind], ckpt)
    b = tmp_path / "b"
    shutil.copytree(a, b)
    port = make_port(a, wal_shards=2)
    ref = make_ref(b, wal_shards=2)
    got, want = state_to_numpy(port.state), ref_arrays(ref.state)
    assert_same_arrays(got, want, f"{kind} dir reopened")
    if kind == "pre_telemetry":
        # the checkpoint's telemetry is gone: only the replayed WAL tail
        # counts, below what the writer counted
        steps = f"telem:{ref_lockstep.LaneTelemetry._fields.index('steps')}"
        assert got[steps].sum() < np.asarray(state.telem.steps).sum()
    for e in (ref, port):
        e._dur.flush_all()
        e.step(np.full(N, 2, np.int32), np.ones((N, K, 1), np.int32))
        e._dur.flush_all()
    assert_same_arrays(state_to_numpy(port.state), ref_arrays(ref.state),
                       f"{kind} after a step")
    ref.close()
    port.close()


# -- the reference's behaviour tests, ported ---------------------------------

def make_engine(path, **kw):
    return make_port(path, **{"ring_capacity": 256, **kw})


def drive(eng, n_steps, cmds=4, value=1):
    for _ in range(n_steps):
        eng.step(np.full((N,), cmds, np.int32),
                 np.full((N, K, 1), value, np.int32))


def settle(eng, max_steps=50):
    for _ in range(max_steps):
        eng.step(np.zeros((N,), np.int32), np.zeros((N, K, 1), np.int32))
        eng._dur.drain_all()
        eng._dur.wal.flush()
    return eng


def leader_commits(eng):
    st = eng.state
    return st.commit.numpy()[np.arange(N), st.leader_slot.numpy()]


def test_commits_gate_on_wal_confirm(tmp_path):
    eng = make_engine(tmp_path)
    drive(eng, 10)
    settle(eng, 5)
    assert eng.committed_total() > 0
    assert (leader_commits(eng) <= eng._dur.confirm_upto).all()
    eng.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_commits_freeze_when_wal_dies(tmp_path):
    eng = make_engine(tmp_path, wal_supervise=False)
    drive(eng, 6)
    settle(eng, 5)
    before = eng.committed_total()
    eng._dur.wal.kill()
    n_new = np.full((N,), 4, np.int32)
    payloads = np.ones((N, K, 1), np.int32)
    for _ in range(6):
        try:
            eng.step(n_new, payloads)
        except WalDown:
            pass
    assert int(leader_commits(eng).sum()) <= int(eng._dur.confirm_upto.sum())
    eng._dur.wal.restart()
    for _ in range(10):
        try:
            eng.step(n_new, payloads)
        except WalDown:
            time.sleep(0.05)
    settle(eng, 10)
    assert eng.committed_total() > before
    eng.close()


def test_checkpoint_prunes_wal_files(tmp_path):
    eng = make_engine(tmp_path)
    drive(eng, 8)
    eng.checkpoint()
    files = [f for f in os.listdir(tmp_path / "wal") if f.endswith(".wal")]
    assert len(files) == 1              # the fresh post-rollover file
    assert (tmp_path / "ckpt.npz").exists()
    eng.close()
    with pytest.raises(RuntimeError, match="durable"):
        LockstepEngine(CounterMachine(), N, P, device="cpu").checkpoint()


def test_recover_revives_failed_member_by_snapshot(tmp_path):
    eng = make_engine(tmp_path, ring_capacity=64)
    drive(eng, 4)
    settle(eng, 5)
    eng.fail_member(0, 1)
    drive(eng, 40)                      # far past the ring: frozen cursor
    settle(eng, 5)
    eng.checkpoint()
    st = eng.state
    leader_mac = st.mac.numpy()[np.arange(N), st.leader_slot.numpy()]
    eng.close()
    eng2 = make_engine(tmp_path, ring_capacity=64)
    assert bool(eng2.state.active[0, 1])
    drive(eng2, 4)
    settle(eng2, 10)
    st2 = eng2.state
    mac, act = st2.mac.numpy(), st2.active.numpy()
    for i in range(N):
        vals = mac[i][act[i]]
        assert (vals == vals[0]).all(), (i, mac[i], act[i])
    assert (mac[np.arange(N), st2.leader_slot.numpy()] >= leader_mac).all()
    eng2.close()


def test_unported_mesh_aux_raises(tmp_path):
    """A sharded aux whose lane pieces do not add up to the bridge's
    lanes is refused before anything is queued."""
    from ra_tpu_torch.engine.shards import LaneParts
    eng = make_engine(tmp_path)
    piece = torch.zeros((N - 1,), dtype=torch.int32)
    aux = {k: LaneParts([piece], 0) for k in
           ("appended_hi", "n_app", "n_acc", "row_csum", "flat_rows")}
    with pytest.raises(ValueError, match="lanes"):
        eng._dur.submit(aux)
    assert eng._dur.step_seq == 0
    eng.close()


_CHILD = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.models import CounterMachine

N, P, K, SK = 16, 3, 8, 4
eng = open_engine(CounterMachine(), sys.argv[1], N, P, sync_mode=1,
                  ring_capacity=256, max_step_cmds=K, wal_shards=4,
                  max_pending=32, device="cpu")
report = sys.argv[2]
n_blk = np.full((SK, N), 4, np.int32)
p_blk = np.ones((SK, N, K, 1), np.int32)
lane = np.arange(N)
for i in range(10_000):
    eng.superstep(n_blk, p_blk)
    if i % 5 == 4:
        # the fsync-confirmed commit frontier, reported crash-safely
        st = eng.state
        com = st.commit.numpy()[lane, st.leader_slot.numpy()]
        com = np.minimum(com, eng._dur.confirm_upto)
        with open(report + ".tmp", "w") as f:
            json.dump([int(x) for x in com], f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(report + ".tmp", report)
        print("REPORTED", i, flush=True)
"""


def test_kill9_recovers_all_reported_commits(tmp_path):
    """SIGKILL a port engine driven in 4-step supersteps over 4 WAL
    shards: every commit it ever reported (only after its WAL block was
    fsynced) survives recovery, and every replica's counter equals its
    apply frontier (the workload is pure +1 commands)."""
    import json
    import select
    data, report = str(tmp_path / "data"), str(tmp_path / "report.json")
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO), data, report],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    reports, buf, fd = 0, b"", child.stdout.fileno()
    while time.time() < deadline and reports < 4:
        ready, _, _ = select.select([fd], [], [],
                                    max(0.0, deadline - time.time()))
        chunk = os.read(fd, 65536) if ready else b""
        if not chunk:
            break
        buf += chunk
        reports = sum(1 for line in buf.split(b"\n")[:-1]
                      if line.startswith(b"REPORTED"))
    child.send_signal(signal.SIGKILL)
    child.wait(timeout=30)
    assert reports >= 4, child.stderr.read()
    with open(report) as f:
        reported = np.array(json.load(f), np.int32)
    assert reported.sum() > 0
    eng = make_engine(tmp_path / "data", sync_mode=1, wal_shards=4)
    st = eng.state
    lead = st.leader_slot.numpy()
    assert (leader_commits(eng) >= reported).all()
    mac, app, act = st.mac.numpy(), st.applied.numpy(), st.active.numpy()
    assert (mac[act] == app[act]).all()
    assert (mac[np.arange(N), lead] >= reported).all()
    eng.close()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def card_engine(path, dev, **kw):
    return open_engine(CounterMachine(), str(path), N, P, device=dev,
                       **{**ENG_KW, "ring_capacity": 1024, "max_pending": 64,
                          **kw})


@pytest.mark.cuda
def test_durable_graph_superstep_matches_eager_steps_on_card(tmp_path,
                                                             cuda_device):
    """With a barrier before each dispatch (the same confirms), the
    captured durable graph, the same K steps run eagerly on the card and
    a CPU engine end every dispatch equal, and write equal counters and
    WAL records."""
    graph = card_engine(tmp_path / "g", cuda_device, wal_shards=2)
    eager = card_engine(tmp_path / "e", cuda_device, wal_shards=2)
    eager._graphs = None                  # _superstep's K-step loop
    cpu = card_engine(tmp_path / "c", "cpu", wal_shards=2)
    engines = (graph, eager, cpu)
    rng = np.random.default_rng(12)
    launches = commit_phase.LAUNCHES
    for d in range(5):
        n_new = rng.integers(0, K + 1, (4, N)).astype(np.int32)
        pay = rng.integers(-9, 10, (4, N, K, 1)).astype(np.int32)
        elect = np.zeros((4, N), bool)
        elect[1 + d % 3, rng.choice(N, 3, replace=False)] = True
        barrier(*engines)
        auxes = [e.superstep(n_new, pay, elect_blk=elect) for e in engines]
        torch.cuda.synchronize()
        barrier(*engines)
        want = state_to_numpy(cpu.state)
        for e, aux, name in zip(engines, auxes, ("graph", "eager")):
            assert_same_arrays(state_to_numpy(e.state), want,
                               f"{name} state {d}")
            assert_same_arrays({k: v.cpu().numpy() for k, v in aux.items()},
                               {k: v.numpy() for k, v in auxes[2].items()},
                               f"{name} aux {d}")
            assert e._dur.counters == cpu._dur.counters
    assert commit_phase.LAUNCHES - launches >= 4 * 5     # the eager steps
    for e in engines:
        e.close()
    for d in ("g", "e"):
        assert_records_equal(str(tmp_path / "c"), str(tmp_path / d))


@pytest.mark.cuda
def test_durable_driver_loop_makes_no_host_sync(tmp_path, cuda_device):
    """A durable superstep loop without elections through the driver
    issues no synchronizing CUDA call on the dispatch thread: the confirm
    horizon goes to the card from pinned memory, the WAL header readback
    and the shards' row copies are asynchronous."""
    eng = card_engine(tmp_path / "g", cuda_device, wal_shards=2)
    cpu = card_engine(tmp_path / "c", "cpu", wal_shards=2)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    nb = np.full((8, N), 2, np.int32)
    pb = np.ones((8, N, K, 1), np.int32)
    for _ in range(3):
        drv.submit(nb, pb)
    drv.drain()
    eng._dur.flush_all()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.from_numpy(np.zeros(4, bool)).to(cuda_device)
        for _ in range(6):
            drv.submit(nb, pb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    drv.drain()
    for _ in range(9):
        cpu.superstep(nb, pb)
    for e in (eng, cpu):
        for _ in range(6):
            e._dur.flush_all()
            e.step(np.zeros(N, np.int32), np.zeros((N, K, 1), np.int32))
    np.testing.assert_array_equal(eng.state.total_committed.cpu(),
                                  cpu.state.total_committed)
    assert eng._dur.counters == cpu._dur.counters
    eng.close()
    cpu.close()


@pytest.mark.cuda
def test_capture_of_a_new_key_while_shards_are_busy(tmp_path, cuda_device):
    """A new (K, Kc) captures its graph mid-run while the WAL shards still
    hold queued blocks: the engine drains them first, the capture
    succeeds, and the results equal a CPU engine's."""
    eng = card_engine(tmp_path / "g", cuda_device, wal_shards=4)
    cpu = card_engine(tmp_path / "c", "cpu", wal_shards=4)
    rng = np.random.default_rng(3)
    captures = devicewatch.WATCH.counters["compiles"]
    for kc in (K, 4, K, 2):
        n_new = rng.integers(0, kc + 1, (4, N)).astype(np.int32)
        pay = rng.integers(1, 9, (4, N, kc, 1)).astype(np.int32)
        for e in (eng, cpu):
            for _ in range(3):
                e.superstep(n_new, pay)        # queue blocks on the shards
    assert devicewatch.WATCH.counters["compiles"] - captures == 3
    for e in (eng, cpu):
        e._dur.flush_all()
    assert eng._dur.counters == cpu._dur.counters
    eng.close()
    cpu.close()
    assert_records_equal(str(tmp_path / "c"), str(tmp_path / "g"))
