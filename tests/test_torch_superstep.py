"""The port's superstep and dispatch-ahead driver against the JAX engine.

One seeded schedule of K-round blocks drives the reference
(``ra_tpu.engine.LockstepEngine.superstep``, a ``lax.scan``) and the
port (``device="cpu"``: a loop of K steps); after every dispatch every
LaneState leaf and every stacked aux key must be equal, dtypes
included.  The schedules carry elections at inner steps other than 0,
failures and recoveries between dispatches, query masks, read blocks
and ring backpressure.  The driver is held against plain supersteps and
against the reference's driver.  The ``cuda`` cases hold the captured
CUDA graph against the eager step loop on the card and skip here."""
import numpy as np
import pytest
import torch

from ra_tpu.engine import DispatchAheadDriver as RefDriver
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch import devicewatch
from ra_tpu_torch.convert import state_to_numpy
from ra_tpu_torch.engine import DispatchAheadDriver, LockstepEngine
from ra_tpu_torch.engine.lockstep import step_watermarks
from ra_tpu_torch.models import CounterMachine
from ra_tpu_torch.ops import commit_phase
from test_torch_engine import assert_same, assert_same_arrays

N, P, KC = 64, 5, 4
KW = dict(ring_capacity=64, max_step_cmds=KC, write_delay=1,
          max_step_reads=4, lease_ttl=3, read_timeout=6)


def make_pair(**kw):
    kw = {**KW, **kw}
    return (RefEngine(RefCounter(), N, P, **kw),
            LockstepEngine(CounterMachine(), N, P, device="cpu", **kw))


def both(engines, verb, *args):
    for e in engines:
        getattr(e, verb)(*args)


def assert_aux(ref_aux, port_aux, what):
    assert_same_arrays({k: v.cpu().numpy() for k, v in port_aux.items()},
                       {k: np.asarray(v) for k, v in ref_aux.items()},
                       f"aux {what}")


def schedule(rng, k, rnd):
    """One block: commands, elections at an inner step other than 0 (when
    k > 1) on lanes 0-7 and a few random lanes at the last inner step,
    query masks, and on odd rounds a read block."""
    n_new = rng.integers(0, KC + 1, (k, N)).astype(np.int32)
    pay = rng.integers(-9, 10, (k, N, KC, 1)).astype(np.int32)
    elect = np.zeros((k, N), bool)
    elect[min(1, k - 1), :8] = True
    elect[k - 1] |= rng.random(N) < 0.1
    kw = {"elect_blk": elect, "query_blk": rng.random((k, N)) < 0.2}
    if rnd % 2:
        n_read = np.zeros((k, N), np.int32)
        n_read[0] = np.where(rng.random(N) < 0.5,
                             rng.integers(1, 6, N), 0)
        kw["n_read_blk"] = n_read
        kw["read_q_blk"] = rng.integers(0, 9, (k, N, 4, 1)).astype(np.int32)
    return n_new, pay, kw


def fail_and_heal(engines, failed):
    """Between dispatches: recover last round's failed members that do not
    lead their lane, then fail the leader of lanes 0-7 (they elect inside
    the next block) and a follower of lanes 8-15."""
    leader = engines[-1].state.leader_slot.cpu().numpy()
    heal = [(lane, slot) for lane, slot in failed if slot != leader[lane]]
    if heal:
        lanes, slots = zip(*heal)
        both(engines, "recover_members", list(lanes), list(slots))
    failed[:] = [(lane, int(leader[lane])) for lane in range(8)] + \
        [(lane, (int(leader[lane]) + 1) % P) for lane in range(8, 16)]
    for lane, slot in failed:
        both(engines, "fail_member", lane, slot)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_superstep_matches_reference_every_dispatch(k):
    ref, port = make_pair()
    rng = np.random.default_rng(100 + k)
    before = commit_phase.LAUNCHES
    failed = []
    for rnd in range(4):
        fail_and_heal((ref, port), failed)
        n_new, pay, kw = schedule(rng, k, rnd)
        ref_aux = ref.superstep(n_new, pay, **kw)
        port_aux = port.superstep(n_new, pay, **kw)
        assert_same(ref, port, what=f"k={k} dispatch {rnd}")
        assert_aux(ref_aux, port_aux, f"k={k} dispatch {rnd}")
        # the stacked watermarks: one row per inner step, monotone,
        # ending at the engine's state
        com = port_aux["committed_lanes"].numpy().astype(np.int64)
        assert com.shape == (k, N) and port_aux["applied_lanes"].shape == \
            (k, N)
        assert (np.diff(com, axis=0) >= 0).all()
        np.testing.assert_array_equal(com[-1],
                                      port.state.total_committed.numpy())
    st = port.state
    assert int(st.telem.leader_changes.sum()) > 0
    assert int(st.read_served.sum()) > 0
    assert int(st.total_committed.sum()) > 0
    assert commit_phase.LAUNCHES == before            # CPU: plain version
    pc = port.pipeline_counters
    assert pc == {**pc, "superstep_dispatches": 4, "dispatches": 4,
                  "inner_steps": 4 * k}
    assert port.overview(0)["pipeline"]["superstep_k"] == k


def test_superstep_ring_backpressure_parity():
    """Bursts past the ring's headroom inside a dispatch clip exactly as
    K single steps do, in both engines."""
    kw = dict(ring_capacity=16, max_step_cmds=8, apply_window=4)
    ref, port = make_pair(**kw)
    steps = LockstepEngine(CounterMachine(), N, P, device="cpu",
                           **{**KW, **kw})
    rng = np.random.default_rng(7)
    clipped = 0
    for rnd in range(4):
        n_new = np.full((4, N), 8, np.int32)
        pay = rng.integers(1, 5, (4, N, 8, 1)).astype(np.int32)
        ref_aux = ref.superstep(n_new, pay)
        port_aux = port.superstep(n_new, pay)
        for j in range(4):
            steps.step(n_new[j], pay[j])
        assert_same(ref, port, what=f"backpressure {rnd}")
        assert_aux(ref_aux, port_aux, f"backpressure {rnd}")
        assert_same_arrays(state_to_numpy(port.state),
                           state_to_numpy(steps.state), "superstep vs steps")
        clipped += int((port_aux["n_acc"].numpy() < 8).sum())
    assert clipped > 0


def blocks(rng, n, k=2):
    return [(np.full((k, N), 2, np.int32),
             rng.integers(1, 9, (k, N, KC, 1)).astype(np.int32))
            for _ in range(n)]


def test_dispatch_ahead_driver_matches_plain_supersteps():
    """The driver is a pure pipelining layer: the state equals the same
    blocks through superstep(), and the reference driver's; the
    in-flight cap holds; drain() returns the final watermark."""
    ref, port = make_pair()
    plain = LockstepEngine(CounterMachine(), N, P, device="cpu", **KW)
    bl = blocks(np.random.default_rng(3), 6)
    for nb, pb in bl:
        plain.superstep(nb, pb)
    rdrv = RefDriver(ref, max_in_flight=2)
    drv = DispatchAheadDriver(port, max_in_flight=2)
    assert port._driver is drv
    assert port.overview(0)["pipeline"]["dispatch_ahead"] == 2
    handles = []
    for nb, pb in bl:
        rdrv.submit(nb, pb)
        handles.append(drv.submit(nb, pb))
        assert drv.in_flight() <= 2
    assert handles[0] is None and handles[1].is_ready()
    assert port.overview(0)["pipeline"]["dispatches_in_flight"] == 2
    final = drv.drain()
    rfinal = rdrv.drain()
    assert_same(ref, port, what="driver")
    assert_same_arrays({"s": port.state.total_committed.numpy()},
                       {"s": plain.state.total_committed.numpy()}, "plain")
    np.testing.assert_array_equal(final, port.state.total_committed.numpy())
    assert final.dtype == np.asarray(rfinal).dtype
    np.testing.assert_array_equal(final, rfinal)
    np.testing.assert_array_equal(drv.last_committed, rdrv.last_committed)
    assert port.pipeline_counters == ref.pipeline_counters
    assert port.pipeline_counters["superstep_dispatches"] == 6
    assert port.pipeline_counters["inner_steps"] == 12
    assert port.pipeline_counters["blocks_staged"] == 6
    assert port.pipeline_counters["window_syncs"] == 0   # CPU: always ready
    assert drv.in_flight() == 0
    ph = port.phases.overview()
    assert ph["host_staging"]["count"] == 6
    assert ph["device_dispatch"]["count"] == 6


def test_driver_read_block_matches_reference():
    """A read schedule riding the driver's dispatches: the observed read
    counters and answers equal the reference driver's."""
    ref, port = make_pair()
    rdrv = RefDriver(ref, max_in_flight=2)
    drv = DispatchAheadDriver(port, max_in_flight=2)
    rng = np.random.default_rng(11)
    for i, (nb, pb) in enumerate(blocks(rng, 6)):
        rb = port.uniform_read_block(2, 3, query_value=1) if i % 2 else None
        rdrv.submit(nb, pb, read_blk=rb)
        drv.submit(nb, pb, read_blk=rb)
        for name in ("last_read_served", "last_read_shed",
                     "last_read_stale"):
            got, want = getattr(drv, name), getattr(rdrv, name)
            assert (got is None) == (want is None), name
            if got is not None:
                assert_same_arrays({name: got}, {name: np.asarray(want)},
                                   f"after submit {i}")
    drv.drain()
    rdrv.drain()
    assert_same(ref, port, what="read driver")
    assert len(drv.read_obs) == len(rdrv.read_obs) == 6
    for i, (got, want) in enumerate(zip(drv.read_obs, rdrv.read_obs)):
        assert_same_arrays(got, {k: np.asarray(v) for k, v in want.items()},
                           f"read_obs {i}")
    assert int(drv.last_read_served.sum()) > 0
    assert port.phases.overview()["read_e2e"]["count"] == \
        ref.phases.overview()["read_e2e"]["count"] > 0


def test_uniform_read_block_matches_reference():
    ref, port = make_pair()
    for k, r in ((1, 2), (3, 9)):
        got = port.uniform_read_block(k, r, query_value=5)
        want = ref.uniform_read_block(k, r, query_value=5)
        assert_same_arrays({"n": got[0], "q": got[1]},
                           {"n": np.asarray(want[0]),
                            "q": np.asarray(want[1])}, f"k={k}")


def test_uniform_superstep_and_readback_match_reference():
    ref, port = make_pair()
    ref_aux = ref.uniform_superstep(3, 2)
    port_aux = port.uniform_superstep(3, 2)
    assert_same(ref, port, ref_aux, port_aux, what="uniform_superstep")
    h = port.committed_lanes_async()
    assert h.is_ready()
    got = np.asarray(h)
    assert_same_arrays({"c": got},
                       {"c": np.asarray(ref.committed_lanes_async())},
                       "committed_lanes_async")
    port.uniform_superstep(2, 1)
    np.testing.assert_array_equal(np.asarray(h), got)   # a snapshot
    port.block_until_ready()


def test_unported_options_raise():
    port = LockstepEngine(CounterMachine(), 8, 3, device="cpu")
    # shardings only for an engine sharded over their mesh
    with pytest.raises(ValueError, match="not sharded"):
        DispatchAheadDriver(port, shardings={})
    with pytest.raises(ValueError, match="max_in_flight"):
        DispatchAheadDriver(port, max_in_flight=0)


def test_ledger_counts_driver_copies_like_reference():
    """The transfer ledger's bytes and events per site for a driver loop
    with reads and an async commit readback equal the reference's."""
    from ra_tpu.devicewatch import WATCH as REF_WATCH
    sites = ("driver_stage", "driver_watermark", "driver_read",
             "lanes_async")
    ref, port = make_pair()
    r0 = {s: dict(REF_WATCH.sites[s]) for s in sites}
    p0 = {s: dict(devicewatch.WATCH.sites[s]) for s in sites}
    rdrv = RefDriver(ref, max_in_flight=2)
    drv = DispatchAheadDriver(port, max_in_flight=2)
    for i, (nb, pb) in enumerate(blocks(np.random.default_rng(5), 4)):
        rb = port.uniform_read_block(2, 1) if i == 1 else None
        rdrv.submit(nb, pb, read_blk=rb)
        drv.submit(nb, pb, read_blk=rb)
    rdrv.drain()
    drv.drain()
    np.asarray(ref.committed_lanes_async())
    np.asarray(port.committed_lanes_async())
    for s in sites:
        got = {k: v - p0[s][k] for k, v in devicewatch.WATCH.sites[s].items()}
        want = {k: v - r0[s][k] for k, v in REF_WATCH.sites[s].items()}
        assert got == want, s
        assert sum(got.values()) > 0, s


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def stacked_steps(eng, n_new, pay, **kw):
    """K eager ``step()`` calls, the aux stacked as superstep stacks it;
    ``kw`` holds superstep's schedule keywords."""
    names = {"elect_blk": "elect_mask", "query_blk": "query_mask",
             "n_read_blk": "n_read", "read_q_blk": "read_q"}
    auxes = []
    for j in range(n_new.shape[0]):
        aux = eng.step(n_new[j], pay[j],
                       **{names[name]: v[j] for name, v in kw.items()})
        auxes.append({**aux, **step_watermarks(eng.state)})
    return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_graph_superstep_matches_eager_steps_on_card(cuda_device, k):
    """Each dispatch replays the captured graph; state and stacked aux
    equal K eager steps on the card; an aux and a state held by the
    caller do not change under later dispatches."""
    graph = LockstepEngine(CounterMachine(), N, P, device=cuda_device, **KW)
    eager = LockstepEngine(CounterMachine(), N, P, device=cuda_device, **KW)
    rng = np.random.default_rng(200 + k)
    held = None
    failed = []
    for rnd in range(4):
        fail_and_heal((graph, eager), failed)
        n_new, pay, kw = schedule(rng, k, rnd)
        aux = graph.superstep(n_new, pay, **kw)
        want = stacked_steps(eager, n_new, pay, **kw)
        torch.cuda.synchronize()
        assert_same_arrays(
            {k2: v.cpu().numpy() for k2, v in aux.items()},
            {k2: v.cpu().numpy() for k2, v in want.items()}, f"aux {rnd}")
        assert_same_arrays(state_to_numpy(graph.state),
                           state_to_numpy(eager.state), f"state {rnd}")
        if held is not None:
            assert_same_arrays({k2: v.cpu().numpy()
                                for k2, v in held[0].items()},
                               held[1], "held aux")
            assert_same_arrays(state_to_numpy(held[2]), held[3],
                               "held state")
        held = (aux, {k2: v.cpu().numpy() for k2, v in aux.items()},
                graph.state, state_to_numpy(graph.state))
    assert len(graph._graphs) == 2                    # with and w/o reads


@pytest.mark.cuda
def test_steady_driver_loop_makes_no_capture(cuda_device):
    eng = LockstepEngine(CounterMachine(), N, P, device=cuda_device, **KW)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    nb = np.full((8, N), 2, np.int32)
    pb = np.ones((8, N, KC, 1), np.int32)
    for _ in range(3):
        drv.submit(nb, pb)
    drv.drain()
    c0 = dict(devicewatch.WATCH.counters)
    launches = commit_phase.LAUNCHES
    for _ in range(10):
        drv.submit(nb, pb)
    drv.drain()
    c1 = dict(devicewatch.WATCH.counters)
    assert c1["compiles"] == c0["compiles"]
    assert c1["recompiles"] == c0["recompiles"]
    assert commit_phase.LAUNCHES == launches          # replays only
    assert (drv.last_committed == eng.state.total_committed.cpu().numpy()
            ).all()
    # a new (K, Kc) captures exactly once
    eng.superstep(np.full((3, N), 1, np.int32), np.ones((3, N, 2, 1),
                                                        np.int32))
    eng.superstep(np.full((3, N), 1, np.int32), np.ones((3, N, 2, 1),
                                                        np.int32))
    c2 = devicewatch.WATCH.counters
    assert c2["compiles"] == c1["compiles"] + 1
    # a new shape at a site that had one is a recompile, and the
    # sentinel names the block leaf whose shape drifted
    assert c2["recompiles"] == c1["recompiles"] + 1
    drift = devicewatch.WATCH.per_fn["superstep"]["last_drift"]
    assert drift.startswith("[0][1]: shape") and f"(8, {N})" in drift \
        and f"(3, {N})" in drift, drift


@pytest.mark.cuda
def test_window_syncs_count_a_real_wait(cuda_device):
    """A window-boundary take that has to wait for the device counts in
    window_syncs; one that finds its copy landed does not.  The device is
    held busy with ``torch.cuda._sleep`` ahead of each dispatch."""
    eng = LockstepEngine(CounterMachine(), N, P, device=cuda_device, **KW)
    drv = DispatchAheadDriver(eng, max_in_flight=1)
    nb = np.full((8, N), 2, np.int32)
    pb = np.ones((8, N, KC, 1), np.int32)
    drv.submit(nb, pb)
    drv.drain()
    for _ in range(6):              # the host waits on the device
        torch.cuda._sleep(50_000_000)
        drv.submit(nb, pb)
    drv.drain()
    waited = eng.pipeline_counters["window_syncs"]
    assert 3 <= waited <= 5
    for _ in range(6):              # the device is done before each take
        drv.submit(nb, pb)
        torch.cuda.synchronize()
    drv.drain()
    assert eng.pipeline_counters["window_syncs"] == waited


@pytest.mark.cuda
def test_driver_loop_with_failed_member_makes_no_host_sync(cuda_device):
    """With a member down and an election schedule in every block, a
    steady driver loop (sampler attached) issues no synchronizing CUDA
    call: the fail and elect masks reach the card from pinned memory
    without blocking, so the host keeps staging ahead of the device.
    Under ``set_sync_debug_mode("error")`` a pageable copy raises; the
    driver's waits on events at a window boundary are not such calls.
    The result equals the CPU engine's."""
    from ra_tpu_torch.telemetry import TelemetrySampler
    eng = LockstepEngine(CounterMachine(), N, P, device=cuda_device, **KW)
    cpu = LockstepEngine(CounterMachine(), N, P, device="cpu", **KW)
    TelemetrySampler(eng, cadence_steps=8)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    cdrv = DispatchAheadDriver(cpu, max_in_flight=2)
    rng = np.random.default_rng(7)
    nb = np.full((8, N), 2, np.int32)
    pb = np.ones((8, N, KC, 1), np.int32)
    elect = np.zeros((8, N), bool)
    for e in (eng, cpu):
        e.fail_member(3, 1)
    for d in (drv, cdrv):
        for _ in range(3):                 # capture, stage and sample
            d.submit(nb, pb, elect_blk=elect)
        d.drain()
    torch.cuda.synchronize()
    blocks_ = []
    for _ in range(8):
        el = np.zeros((8, N), bool)
        el[int(rng.integers(1, 8)), rng.choice(N, 4, replace=False)] = True
        blocks_.append(el)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode catches a pageable copy
            torch.from_numpy(np.zeros(4, bool)).to(cuda_device)
        for el in blocks_:
            drv.submit(nb, pb, elect_blk=el)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    drv.drain()
    for el in blocks_:
        cdrv.submit(nb, pb, elect_blk=el)
    cdrv.drain()
    assert (drv.last_committed == cdrv.last_committed).all()
    assert_same_arrays(state_to_numpy(eng.state), state_to_numpy(cpu.state),
                       "state after the driver loop")
