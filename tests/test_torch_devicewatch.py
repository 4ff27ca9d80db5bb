"""The port's device plane (``ra_tpu_torch/devicewatch.py``: the capture
sentinel, the transfer ledger, the memory watermarks) and the WAL's
group-commit wait, against the reference's.

On the CPU a port engine captures no graph, so the capture sentinel is
held here through ``GraphCache`` with ``CapturedCall`` replaced by an
eager stand-in (the sentinel's bookkeeping is the cache's, not the
capture's); the ``cuda`` tests hold the real captures on the card: steady
single-step, K = 8 driver and ingress pump loops at 0 re-captures, a
shape drift re-captured and attributed, the watermark census on the
harvest cadence, and a small autotuned durable loop.

Departure pinned here (a departure of measurement, not of results): the
reference's census counts ``jax.live_arrays()``; the port reads the CUDA
caching allocator's counters, which include captured graphs' private
pools, and on the CPU it takes no census at all (``sample_watermarks``
returns False, as the reference does on a backend without
``live_arrays``).
"""
import numpy as np
import pytest
import torch

from ra_tpu import metrics as ref_metrics
from ra_tpu import devicewatch as ref_devicewatch
import ra_tpu.engine.lockstep as ref_lockstep
from ra_tpu.engine import DispatchAheadDriver as RefDriver
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.log.wal import Wal as RefWal
from ra_tpu.log.wal import scan_wal_file as ref_scan_wal_file
from ra_tpu.models import CounterMachine as RefCounter
import ra_tpu.autotune as ref_autotune
import ra_tpu.slo as ref_slo
import ra_tpu.telemetry as ref_telemetry
import ra_tpu_torch.autotune as port_autotune
import ra_tpu_torch.slo as port_slo
import ra_tpu_torch.telemetry as port_telemetry
from ra_tpu_torch import blackbox, devicewatch, metrics
from ra_tpu_torch.devicewatch import WATCH
from ra_tpu_torch.engine import DispatchAheadDriver, LockstepEngine, graph
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.log.wal import Wal, scan_wal_file
from ra_tpu_torch.models import CounterMachine
from test_torch_durable import assert_records_equal
from test_torch_engine import assert_same
from test_torch_slo_autotune import Clock
from test_torch_classic_card import cuda_device  # noqa: F401

N, P, KC = 16, 3, 4


def mk_pair(lanes=N, cmds=KC, ring=64):
    kw = dict(ring_capacity=ring, max_step_cmds=cmds)
    return (RefEngine(RefCounter(), lanes, P, donate=False, **kw),
            LockstepEngine(CounterMachine(), lanes, P, device="cpu", **kw))


def compile_snap():
    return (WATCH.counters["compiles"], WATCH.counters["recompiles"])


def site_delta(watch, site, before):
    now = watch.sites[site]
    return {k: now[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# registry + surface shape
# ---------------------------------------------------------------------------

def test_device_fields_registered_and_covered_by_overview():
    assert metrics.DEVICE_FIELDS == ref_metrics.DEVICE_FIELDS
    assert metrics.FIELD_REGISTRY["device"] is metrics.DEVICE_FIELDS
    assert set(metrics.FIELD_REGISTRY) <= set(ref_metrics.FIELD_REGISTRY)
    snap = WATCH.overview()
    ref = ref_devicewatch.WATCH.overview()
    for f in metrics.DEVICE_FIELDS:
        assert f in snap, f
    assert set(snap) == set(ref)


def test_bench_tail_keys_shape():
    tail = devicewatch.bench_tail_keys()
    assert set(tail) == set(ref_devicewatch.bench_tail_keys())
    assert tail["transfer_bytes"] == \
        WATCH.counters["h2d_bytes"] + WATCH.counters["d2h_bytes"]
    with_cmds = devicewatch.bench_tail_keys(commands=1000)
    assert with_cmds["transfer_bytes_per_cmd"] == \
        round(with_cmds["transfer_bytes"] / 1000, 4)


def test_reset_and_disabled_taps():
    w = devicewatch.DeviceWatch()
    w.record_h2d("s", 10)
    w.note_capture("superstep", 1.5, "drift")
    assert w.counters["h2d_bytes"] == 10 and w.counters["recompiles"] == 1
    w.reset()
    assert w.counters == {f: (0.0 if f == "compile_ms" else 0)
                          for f in metrics.DEVICE_FIELDS}
    assert not w.sites and not w.per_fn
    w.enabled = False
    w.record_d2h("s", 10)
    w.note_capture("superstep", 1.0, None)
    assert not w.sample_watermarks()
    assert w.counters["d2h_events"] == 0 and w.counters["compiles"] == 0


# ---------------------------------------------------------------------------
# steady-state loops: a fixed transfer budget, no capture
# ---------------------------------------------------------------------------

def test_single_step_loop_steady_state():
    """Warm single steps with an async committed readback each: the same
    lanes_async budget as the reference's, window for window, and no
    capture."""
    ref, port = mk_pair()
    n_new = np.full((N,), 2, np.int32)
    pay = np.ones((N, KC, 1), np.int32)
    for e in (ref, port):
        for _ in range(3):
            e.step(n_new, pay)
            e.committed_lanes_async()
        e.block_until_ready()

    def window():
        c0 = compile_snap()
        out = []
        for e, w in ((ref, ref_devicewatch.WATCH), (port, WATCH)):
            s0 = dict(w.sites["lanes_async"])
            for _ in range(20):
                e.step(n_new, pay)
                e.committed_lanes_async()
            e.block_until_ready()
            out.append(site_delta(w, "lanes_async", s0))
        assert compile_snap() == c0
        return out

    (r1, p1), (r2, p2) = window(), window()
    assert p1 == r1 == p2 == r2
    assert p1["d2h_events"] == 20 and p1["d2h_bytes"] == 20 * 4 * N
    assert_same(ref, port, what="single-step loop")


def test_superstep_k8_driver_loop_steady_state():
    ref, port = mk_pair()
    drivers = {"ref": (RefDriver(ref, max_in_flight=2),
                       ref_devicewatch.WATCH),
               "port": (DispatchAheadDriver(port, max_in_flight=2), WATCH)}
    nb = np.full((8, N), 2, np.int32)
    pb = np.ones((8, N, KC, 1), np.int32)
    for drv, _w in drivers.values():
        for _ in range(3):
            drv.submit(nb, pb)
        drv.drain()

    def window():
        c0 = compile_snap()
        out = {}
        for name, (drv, w) in drivers.items():
            h0 = dict(w.sites["driver_stage"])
            d0 = dict(w.sites["driver_watermark"])
            for _ in range(10):
                drv.submit(nb, pb)
            drv.drain()
            out[name] = (site_delta(w, "driver_stage", h0),
                         site_delta(w, "driver_watermark", d0))
        assert compile_snap() == c0
        return out

    w1, w2 = window(), window()
    assert w1["port"] == w1["ref"] == w2["port"] == w2["ref"]
    h1, d1 = w1["port"]
    assert h1["h2d_events"] == 2 * 10 and d1["d2h_events"] == 10
    assert h1["h2d_bytes"] == 10 * (nb.nbytes + pb.nbytes)
    assert_same(ref, port, what="K=8 driver loop")


def test_driver_restages_a_new_k_between_dispatches():
    """The autotuner's restage: blocks of a new K go through the same
    driver between dispatches (the reference's contract), with the same
    results."""
    ref, port = mk_pair()
    rd, pd = RefDriver(ref, max_in_flight=2), \
        DispatchAheadDriver(port, max_in_flight=2)
    rng = np.random.default_rng(5)
    for k in (1, 2, 1):
        nb = rng.integers(0, KC + 1, (k, N)).astype(np.int32)
        pb = rng.integers(1, 9, (k, N, KC, 1)).astype(np.int32)
        for _ in range(2):
            rd.submit(nb, pb)
            pd.submit(nb, pb)
        assert port.overview()["pipeline"]["superstep_k"] == \
            ref.overview()["pipeline"]["superstep_k"]
    assert np.array_equal(pd.drain(), np.asarray(rd.drain()))
    assert port.pipeline_counters == ref.pipeline_counters
    assert_same(ref, port, what="K walk")


def test_ingress_pump_loop_steady_state():
    from ra_tpu.ingress import IngressPlane as RefPlane
    from ra_tpu_torch.ingress import IngressPlane
    ref, port = mk_pair(lanes=32)
    kw = dict(superstep_k=2, window_s=0.0, soft_credit=64, hard_credit=256)
    planes = (RefPlane(ref, **kw), IngressPlane(port, **kw))
    hs = [p.connect_bulk(100, tenants=4, key="dw") for p in planes]
    assert np.array_equal(hs[0], hs[1])
    rng = np.random.default_rng(9)

    def wave():
        sess = hs[1][rng.integers(0, len(hs[1]), 48)]
        seq = planes[1].directory.next_seqnos(sess)
        pay = rng.integers(1, 5, (48, 1)).astype(np.int32)
        st = [p.submit(sess, seq, pay) for p in planes]
        assert np.array_equal(st[0], st[1])
        for p in planes:
            p.pump(force=True)

    for _ in range(3):
        wave()
    for p in planes:
        p.settle()
    c0 = compile_snap()
    for _ in range(6):
        wave()
    for p in planes:
        p.settle()
    assert compile_snap() == c0
    assert planes[1].counters == planes[0].counters
    assert_same(ref, port, what="ingress pump")


# ---------------------------------------------------------------------------
# the capture sentinel (GraphCache with an eager stand-in for the capture)
# ---------------------------------------------------------------------------

class EagerCall:
    """``CapturedCall``'s interface without CUDA: runs ``fn`` eagerly."""

    def __init__(self, fn, args, device, launch_counts):
        self.fn = fn
        self.capture_ms = 2.5
        self.captured_launches = {}

    def __call__(self, *args):
        return self.fn(*args)


@pytest.fixture
def eager_graphs(monkeypatch):
    monkeypatch.setattr(graph, "CapturedCall", EagerCall)


def superstep_args(k, lanes=6, cmds=3):
    port = LockstepEngine(CounterMachine(), lanes, P, ring_capacity=32,
                          max_step_cmds=cmds, device="cpu")
    return (port.state, torch.full((k, lanes), 2, dtype=torch.int32),
            torch.ones((k, lanes, cmds, 1), dtype=torch.int32))


def test_shape_drift_recapture_is_detected_and_attributed(eager_graphs,
                                                          monkeypatch):
    """A K = 8 -> K = 4 block at one site is a re-capture: counted as a
    recompile, the drifting leaf named as the reference's sentinel names
    it (the reference's own drift string, sharding aside), and the
    registered ``device.recompile`` event recorded.  The reference runs on
    private jit caches: its shared ones must stay as the reference's own
    drift test expects them (that config's K = 4 not yet compiled)."""
    monkeypatch.setattr(ref_lockstep, "_STEP_JIT_CACHE", {})
    monkeypatch.setattr(ref_lockstep, "_SUMMARY_JIT_CACHE", {})
    ref = RefEngine(RefCounter(), 6, 3, ring_capacity=32, max_step_cmds=3,
                    donate=False)
    nb8 = np.full((8, 6), 2, np.int32)
    pb8 = np.ones((8, 6, 3, 1), np.int32)
    ref.superstep(nb8, pb8)
    ref.superstep(nb8[:4], pb8[:4])
    want = ref_devicewatch.WATCH.per_fn["superstep"]["last_drift"]

    cache = graph.GraphCache()
    fn = (lambda *a: a[1].sum())
    a8, a4 = superstep_args(8), superstep_args(4)
    c0 = compile_snap()
    events0 = len(blackbox.RECORDER.events("device"))
    cache.get((8, 3), fn, a8, "cpu", dict)
    cache.get((8, 3), fn, a8, "cpu", dict)        # cached: no capture
    assert compile_snap() == (c0[0] + 1, c0[1])     # a first capture
    cache.get((4, 3), fn, a4, "cpu", dict)
    assert compile_snap() == (c0[0] + 2, c0[1] + 1)
    drift = WATCH.per_fn["superstep"]["last_drift"]
    assert drift.startswith("[0][1]: shape") and \
        "(8, 6)" in drift and "(4, 6)" in drift, drift
    assert drift.split(": ")[0] == want.split(": ")[0]
    assert drift.split(" ")[:3] == want.split(" ")[:3]
    evs = blackbox.RECORDER.events("device")
    assert len(evs) == events0 + 1
    _ts, etype, fields = evs[-1]
    assert etype == "device.recompile" and etype in blackbox.EVENT_REGISTRY
    assert fields["fn"] == "superstep" and fields["compile_ms"] == 2.5


def test_first_capture_of_new_config_is_not_a_recompile(eager_graphs):
    """Another engine's cache, or another variant of the captured function
    (a superstep with a read schedule), is another site: its first
    capture counts as a compile, not a recompile; a key captured again
    after its eviction is one."""
    c0 = compile_snap()
    first = graph.GraphCache()
    first.get((8, 3), lambda *a: None, superstep_args(8), "cpu", dict)
    second = graph.GraphCache()
    second.get((2, 3), lambda *a: None, superstep_args(2), "cpu", dict)
    second.get((2, 3, "reads"), lambda *a: None, superstep_args(2)
               + (torch.zeros((2, 6), dtype=torch.int32),), "cpu", dict,
               variant=True)
    assert compile_snap() == (c0[0] + 3, c0[1])
    for k in range(1, graph.MAX_GRAPHS + 2):        # evicts key 1
        second.get((k, 4), lambda *a: None, superstep_args(k, cmds=4),
                   "cpu", dict)
    assert len(second) == graph.MAX_GRAPHS and (1, 4) not in second
    c1 = compile_snap()
    second.get((1, 4), lambda *a: None, superstep_args(1, cmds=4), "cpu",
               dict)
    assert compile_snap() == (c1[0] + 1, c1[1] + 1)


def test_autotuner_freezes_on_capture_storm(monkeypatch):
    """A capture between ticks freezes tuning (``compile_storm``) for
    ``compile_freeze_s``, as the reference's tuner does on a compile."""
    out = {}
    for name, tel, slo, tun, watch in (
            ("ref", ref_telemetry, ref_slo, ref_autotune,
             ref_devicewatch.WATCH),
            ("port", port_telemetry, port_slo, port_autotune, WATCH)):
        clock = Clock()
        with monkeypatch.context() as m:
            m.setattr(tun, "time", clock)
            m.setattr(tel, "time", clock)
            obs = tel.Observatory()
            tuner = tun.AutoTuner(slo.SloEngine(obs), compile_freeze_s=0.2)
            seq = [tuner._compile_storm_reason()]
            m.setitem(watch.counters, "compiles",
                      watch.counters["compiles"] + 1)
            seq += [tuner._compile_storm_reason(),
                    tuner._compile_storm_reason()]
            clock.sleep(0.25)
            seq.append(tuner._compile_storm_reason())
            obs.close()
        out[name] = seq
    assert out["port"] == out["ref"] == [None, "compile_storm",
                                         "compile_storm", None]


def test_torch_profile_writes_a_trace_and_stamps_the_recorder(tmp_path):
    """``trace.torch_profile``, the counterpart of ``jax_profile``: the
    with-body's profile lands in ``<dir>/trace.json`` and the recorder
    holds a registered ``profile.captured`` event naming the dir."""
    import json

    from ra_tpu_torch import trace
    n0 = len(blackbox.RECORDER.events("profile"))
    with trace.torch_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    evs = blackbox.RECORDER.events("profile")[n0:]
    assert len(evs) == 1 and evs[0][1] == "profile.captured"
    assert evs[0][1] in blackbox.EVENT_REGISTRY
    assert evs[0][2]["dir"] == str(tmp_path / "prof")


# ---------------------------------------------------------------------------
# memory watermarks
# ---------------------------------------------------------------------------

def test_no_census_on_the_cpu():
    """The recorded departure: without an initialised card the port takes
    no census, and a sampler's harvest leaves the watermark fields as
    they were; ``device_memory_stats`` is empty."""
    if torch.cuda.is_initialized():
        pytest.skip("a card is initialised in this process")
    before = dict(WATCH.counters)
    assert WATCH.sample_watermarks() is False
    _ref, port = mk_pair(lanes=8)
    s = port_telemetry.TelemetrySampler(port, cadence_steps=4)
    for _ in range(8):
        port.uniform_step(2)
    s.drain()
    for f in ("live_buffers", "live_bytes", "peak_live_bytes",
              "buffers_freed", "watermark_samples"):
        assert WATCH.counters[f] == before[f], f
    assert WATCH.device_memory_stats() == {}


def test_watermarks_ride_the_harvest_cadence_like_the_reference(
        monkeypatch):
    """With allocator statistics standing in for a card's, the census
    runs on the same harvests as the reference's: the first at once,
    the next after ``CENSUS_MIN_INTERVAL_S`` of the injected clock; no
    sampler, no census.  The counters follow the allocator's: live
    allocations and bytes, the peak, and the frees between samples."""
    stats = {"allocation.all.current": 7, "allocated_bytes.all.current":
             4096, "allocation.all.freed": 100}
    monkeypatch.setattr(devicewatch.DeviceWatch, "_allocator_stats",
                        staticmethod(lambda: dict(stats)))
    # both watches are process-wide: this test's census leaves them as
    # it found them (later tests read the port's peak as "no card")
    for w in (ref_devicewatch.WATCH, WATCH):
        monkeypatch.setattr(w, "counters", dict(w.counters))
    monkeypatch.setattr(WATCH, "_prev_freed", WATCH._prev_freed)
    monkeypatch.setattr(ref_devicewatch.WATCH, "_prev_live_buffers",
                        ref_devicewatch.WATCH._prev_live_buffers)
    samples = {}
    for name, tel, dw, eng in (
            ("ref", ref_telemetry, ref_devicewatch, mk_pair(lanes=8)[0]),
            ("port", port_telemetry, devicewatch, mk_pair(lanes=8)[1])):
        clock = Clock()
        w = dw.WATCH
        with monkeypatch.context() as m:
            m.setattr(dw, "time", clock)
            m.setattr(w, "_last_census_s", float("-inf"))
            w0 = w.counters["watermark_samples"]
            for _ in range(4):
                eng.uniform_step(2)
            seq = [w.counters["watermark_samples"] - w0]   # no sampler
            s = tel.TelemetrySampler(eng, cadence_steps=2)
            for i in range(6):
                eng.uniform_step(2)
                eng.uniform_step(2)
                s.drain()
                clock.sleep(0.1)
                seq.append(w.counters["watermark_samples"] - w0)
        samples[name] = seq
    assert samples["port"] == samples["ref"] == [0, 1, 1, 1, 2, 2, 2]
    c = WATCH.counters
    assert c["live_buffers"] == 7 and c["live_bytes"] == 4096
    assert c["peak_live_bytes"] >= 4096
    f0 = c["buffers_freed"]
    stats.update({"allocation.all.freed": 130,
                  "allocated_bytes.all.current": 1 << 20})
    assert WATCH.sample_watermarks()
    assert c["buffers_freed"] == f0 + 30
    assert c["peak_live_bytes"] >= 1 << 20


# ---------------------------------------------------------------------------
# the WAL's group-commit wait
# ---------------------------------------------------------------------------

def write_burst(wal_cls, path, interval_ms):
    """20 records 2 ms apart (the burst a group-commit wait amortizes),
    then a flush."""
    import time
    confirmed = []
    wal = wal_cls(str(path), sync_mode=1, max_batch_interval_ms=interval_ms)
    try:
        wal.register("u", lambda uid, lo, hi, term: confirmed.append(hi))
        for i in range(1, 21):
            wal.write("u", i, 1, bytes([i]) * 64)
            time.sleep(0.002)
        wal.flush()
        return dict(wal.counters), wal.stats(), max(confirmed)
    finally:
        wal.close()


def scanned(scan, wal_dir):
    import os
    tables: dict = {}
    for name in sorted(os.listdir(wal_dir)):
        if name.endswith(".wal"):
            scan(os.path.join(wal_dir, name), tables)
    return tables


def test_group_commit_amortizes_fsyncs(tmp_path):
    """With a 150 ms wait the burst lands in very few groups: the same
    records as without a wait and as the reference writes, fewer or
    equal fsyncs (the twin of the reference's
    ``test_group_commit_amortizes_fsyncs``)."""
    runs = {}
    for name, cls in (("ref", RefWal), ("port", Wal)):
        for ms in (0.0, 150.0):
            runs[(name, ms)] = write_burst(cls, tmp_path / f"{name}{ms}", ms)
    tables = {key: scanned(ref_scan_wal_file, tmp_path / f"{n}{ms}" / "wal")
              for key in runs for n, ms in [key]}
    assert all(t == tables[("ref", 0.0)] for t in tables.values())
    assert len(tables[("port", 150.0)]["u"]) == 20
    ctr, st, hi = runs[("port", 150.0)]
    assert hi == 20 and ctr["writes"] == 20
    assert ctr["syncs"] <= 3, ctr
    assert ctr["syncs"] <= runs[("port", 0.0)][0]["syncs"]
    assert st["records_per_fsync"] >= 5 and st["fsync_p50_ms"] >= 0
    assert scanned(scan_wal_file, tmp_path / "port150.0" / "wal") == \
        tables[("ref", 150.0)]


def test_group_commit_byte_cap_closes_group(tmp_path):
    """``max_batch_bytes`` closes a group early inside the interval, in
    both packages; a live interval change lands at the next group."""
    import time
    out = {}
    for name, cls in (("ref", RefWal), ("port", Wal)):
        wal = cls(str(tmp_path / name), sync_mode=0,
                  max_batch_interval_ms=500.0, max_batch_bytes=256)
        try:
            wal.register("u", lambda *a: None)
            t0 = time.monotonic()
            for i in range(1, 9):
                wal.write("u", i, 1, b"y" * 128)
            wal.flush()
            assert time.monotonic() - t0 < 2.0
            wal.max_batch_interval_ms = 0.0
            t0 = time.monotonic()
            wal.write("u", 9, 1, b"z")
            wal.flush()
            assert time.monotonic() - t0 < 0.4
            out[name] = (wal.counters["writes"], wal.counters["batches"] >= 2)
        finally:
            wal.close()
    assert out["port"] == out["ref"] == (9, True)


def test_durable_engine_interval_keeps_records_and_state(tmp_path):
    """A durable engine under a group-commit wait writes the records the
    reference writes, recovers the same state as without the wait, and
    takes fewer or equal fsyncs; ``open_engine``'s None is 0.0."""
    kw = dict(ring_capacity=64, max_step_cmds=4, wal_shards=2)
    engines = {
        "ref": ref_open_engine(RefCounter(), str(tmp_path / "ref"), N, P,
                               wal_batch_interval_ms=5.0,
                               wal_batch_bytes=1 << 16, **kw),
        "port": open_engine(CounterMachine(), str(tmp_path / "port"), N,
                            P, wal_batch_interval_ms=5.0,
                            wal_batch_bytes=1 << 16, device="cpu", **kw),
        "port0": open_engine(CounterMachine(), str(tmp_path / "port0"), N,
                             P, device="cpu", **kw)}
    assert engines["port0"]._dur.batch_interval_ms() == 0.0
    assert engines["port"]._dur.batch_interval_ms() == 5.0
    assert [w.max_batch_bytes for w in engines["port"]._dur.wals] == \
        [w.max_batch_bytes for w in engines["ref"]._dur.wals] == [1 << 16] * 2
    rng = np.random.default_rng(11)
    for _ in range(6):
        nb = rng.integers(0, 5, (4, N)).astype(np.int32)
        pb = rng.integers(1, 9, (4, N, 4, 1)).astype(np.int32)
        for e in engines.values():
            e._dur.flush_all()
            e.superstep(nb, pb)
    syncs = {}
    for name, e in engines.items():
        e._dur.flush_all()
        syncs[name] = sum(w.counters["syncs"] for w in e._dur.wals)
    assert engines["port"]._dur.counters == engines["ref"]._dur.counters
    assert_same(engines["ref"], engines["port"], what="interval 5 ms")
    assert syncs["port"] <= syncs["port0"]
    for e in engines.values():
        e.close()
    assert_records_equal(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert_records_equal(str(tmp_path / "ref"), str(tmp_path / "port0"))
    back = {name: open_engine(CounterMachine(), str(tmp_path / name), N, P,
                              device="cpu", **kw)
            for name in ("port", "port0")}
    assert_same(back["port"], back["port0"], what="recovered")
    for e in back.values():
        e.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_steady_loops_make_no_capture_on_card(cuda_device):
    """Warm single-step, K = 8 driver and ingress-pump loops on the card
    capture nothing; a K drift re-captures once, attributed."""
    from ra_tpu_torch.ingress import IngressPlane
    eng = LockstepEngine(CounterMachine(), 64, P, ring_capacity=64,
                         max_step_cmds=KC, device=cuda_device)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    nb = np.full((8, 64), 2, np.int32)
    pb = np.ones((8, 64, KC, 1), np.int32)
    for _ in range(3):
        drv.submit(nb, pb)
        eng.uniform_step(2)
    drv.drain()
    c0 = compile_snap()
    for _ in range(10):
        drv.submit(nb, pb)
        eng.uniform_step(2)
    drv.drain()
    assert compile_snap() == c0
    eng.superstep(nb[:4], pb[:4])
    assert compile_snap() == (c0[0] + 1, c0[1] + 1)
    assert "(8, 64)" in WATCH.per_fn["superstep"]["last_drift"]
    plane = IngressPlane(eng, superstep_k=2, window_s=0.0,
                         soft_credit=64, hard_credit=256)
    h = plane.connect_bulk(100, tenants=4, key="dw")
    rng = np.random.default_rng(9)

    def wave():
        sess = h[rng.integers(0, len(h), 48)]
        plane.submit(sess, plane.directory.next_seqnos(sess),
                     rng.integers(1, 5, (48, 1)).astype(np.int32))
        plane.pump(force=True)

    for _ in range(3):
        wave()
    plane.settle()
    c1 = compile_snap()
    for _ in range(6):
        wave()
    plane.settle()
    assert compile_snap() == c1


@pytest.mark.cuda
def test_watermarks_sampled_on_harvest_cadence_on_card(cuda_device):
    eng = LockstepEngine(CounterMachine(), 64, P, ring_capacity=64,
                         max_step_cmds=KC, device=cuda_device)
    w0 = WATCH.counters["watermark_samples"]
    for _ in range(4):
        eng.uniform_step(2)
    assert WATCH.counters["watermark_samples"] == w0
    s = port_telemetry.TelemetrySampler(eng, cadence_steps=4)
    for _ in range(8):
        eng.uniform_step(2)
    s.drain()
    c = WATCH.counters
    assert c["watermark_samples"] > w0
    assert c["live_buffers"] > 0 and c["live_bytes"] > 0
    assert c["peak_live_bytes"] >= c["live_bytes"]
    assert WATCH.device_memory_stats()["0"]["bytes_in_use"] > 0


@pytest.mark.cuda
def test_small_tune_path_on_card(tmp_path, cuda_device):
    """``chip_smoke.py``'s autotuned durable loop at 512 lanes: knob
    stamps, the live interval on every shard, the exact committed total,
    the Prometheus round trip and the freeze under a DiskFaultPlan."""
    from chip_smoke import tune_loop
    out = tune_loop(cuda_device, str(tmp_path / "wal"), n_lanes=512,
                    cmds=16, seconds=3.0, k_hi=8)
    assert out["committed_exact"] and out["frozen_ticks"] >= 2
