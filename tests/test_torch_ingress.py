"""The port's ingress plane (``ra_tpu_torch/ingress/``) against the
reference's (``ra_tpu/ingress/``): one seeded sequence of connects,
write waves (duplicate resends, credit refusals, tenant deferrals, ring
sheds), read waves, pumps and settles goes to the reference plane over
the JAX engine and to the port's plane over the port's engine on the CPU.
Held equal after every wave: the verdict arrays, ``counters``,
``read_counters``, ``gauges()``, the read replies fanned out; at the end
the committed lane sums and the final engine state, leaf for leaf,
dtypes included.  A durable variant adds ``wal_pending_steps``.

Also: the counter-field registries against the reference's, the engine
hooks the plane uses (``_ingress`` and the overview's ``ingress`` key,
``mesh_shape``, ``pending_steps``, ``devicewatch.bench_tail_keys``),
and the refusal of a mesh."""
import numpy as np
import pytest
import torch

from ra_tpu import metrics as ref_metrics
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.ingress import IngressPlane as RefPlane
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch import devicewatch, metrics
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.ingress import IngressPlane
from ra_tpu_torch.models import CounterMachine
from test_torch_engine import assert_same

LANES, CMDS = 24, 8


def test_registries_match_reference():
    for name in ("INGRESS_FIELDS", "WIRE_FIELDS", "READ_FIELDS"):
        assert getattr(metrics, name) == getattr(ref_metrics, name), name
    for group in ("ingress", "read", "wire"):
        assert metrics.FIELD_REGISTRY[group] == \
            ref_metrics.FIELD_REGISTRY[group]


def _engines(durable_dirs=None):
    kw = dict(ring_capacity=128, max_step_cmds=CMDS, max_step_reads=4,
              lease_ttl=4)
    if durable_dirs is None:
        return (ref_lockstep.LockstepEngine(RefCounter(), LANES, 3,
                                            donate=False, **kw),
                port_lockstep.LockstepEngine(CounterMachine(), LANES, 3,
                                             device="cpu", **kw))
    rd, pd = durable_dirs
    return (ref_open_engine(RefCounter(), rd, LANES, 3, wal_shards=2,
                            sync_mode=0, donate=False, **kw),
            open_engine(CounterMachine(), pd, LANES, 3, wal_shards=2,
                        sync_mode=0, device="cpu", **kw))


def _planes(ref_eng, port_eng):
    kw = dict(superstep_k=2, window_s=0.0, capacity=16, soft_credit=3,
              hard_credit=6, tenant_quota=40)
    ref, port = RefPlane(ref_eng, **kw), IngressPlane(port_eng, **kw)
    got = {"ref": [], "port": []}
    for name, plane in (("ref", ref), ("port", port)):
        plane.on_reads_done = \
            lambda h, s, st, wm, pay, _l=got[name]: _l.append(
                (h.copy(), s.copy(), st.copy(), wm.copy(), pay.copy()))
    return ref, port, got


def _assert_planes_equal(ref, port, what):
    assert port.counters == ref.counters, what
    assert port.read_counters == ref.read_counters, what
    assert port.gauges() == ref.gauges(), what
    assert port.window.overview() == ref.window.overview(), what
    assert port.ladder.overview() == ref.ladder.overview(), what


def _drive(ref, port, replies, rng, waves=14, barrier=lambda: None):
    """The seeded sequence, the same calls on both planes; ``barrier``
    runs before each pump and each comparison (a durable engine's flush,
    so that the two see the same confirmed steps)."""
    both = (ref, port)
    hs = [p.connect_bulk(300, key="fleet", tenants=4) for p in both]
    assert np.array_equal(hs[0], hs[1])
    fleet = hs[1]
    named = [[p.connect(f"acme/{i}") for i in range(3)] for p in both]
    assert named[0] == named[1]
    lane0 = fleet[port.directory.lane[fleet] == 0]
    for w in range(waves):
        handles = np.concatenate([rng.choice(fleet, 120),
                                  rng.choice(named[1], 6)])
        if w % 3 == 2:               # a burst on one lane: its ring sheds
            handles = np.concatenate([handles, np.repeat(lane0, 4)])
        seq = port.directory.next_seqnos(handles)
        assert np.array_equal(seq, ref.directory.next_seqnos(handles))
        # resends of placed seqnos (dup) and within-wave twins
        stale = rng.random(len(seq)) < 0.1
        seq = np.where(stale, np.maximum(seq - 1, 1), seq)
        handles = np.concatenate([handles, handles[:8]])
        seq = np.concatenate([seq, seq[:8]])
        pay = rng.integers(1, 9, (len(handles), 1)).astype(np.int32)
        if w == 4:
            for p in both:           # tighten: credit halved
                p.ladder.on_verdict("breach")
        if w == 6:
            for p in both:           # tenant fairness: deferrals
                p.ladder.on_verdict("alert")
        if w in (9, 10, 11, 12):
            for p in both:           # clean windows: back to open
                p.ladder.on_verdict("ok")
        st = [p.submit(handles, seq, pay) for p in both]
        assert st[1].dtype == st[0].dtype and np.array_equal(st[1], st[0]), w
        rh = rng.choice(fleet, 40)
        rq = np.zeros((40, 1), np.int32)
        rs = [p.submit_reads(rh, np.arange(40) + 1000 * w, rq)
              for p in both]
        assert np.array_equal(rs[1], rs[0]), w
        force = w % 3 != 1
        barrier()
        assert port.pump(force=force) == ref.pump(force=force), w
        if w % 5 == 4:
            for p in both:
                p.settle()
        barrier()
        _assert_planes_equal(ref, port, f"wave {w}")
        assert len(replies["ref"]) == len(replies["port"])
    for p in both:
        p.settle()
    barrier()
    _assert_planes_equal(ref, port, "settled")
    for a, b in zip(replies["ref"], replies["port"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    c = port.counters
    assert c["dup_dropped"] > 0 and c["rejected"] > 0 and \
        c["shed_rows"] > 0 and c["deferred"] > 0 and \
        c["slow_signals"] > 0
    assert port.read_counters["served"] > 0 and \
        port.read_counters["shed"] > 0
    assert port.gauges()["queue_rows"] == 0
    assert port.gauges()["inflight_blocks"] == 0


def test_plane_matches_reference():
    ref_eng, port_eng = _engines()
    ref, port, replies = _planes(ref_eng, port_eng)
    assert port_eng._ingress is port
    _drive(ref, port, replies, np.random.default_rng(0))
    assert port_eng.overview(0)["ingress"] == ref_eng.overview(0)["ingress"]
    assert port_eng.overview(0)["pipeline"]["mesh_shape"] == \
        ref_eng.mesh_shape() == port_eng.mesh_shape() == ""
    lanes = np.arange(LANES)
    got = port_eng.consistent_read(lanes)
    want = np.asarray(ref_eng.consistent_read(lanes))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert_same(ref_eng, port_eng, what="final")
    assert int(got.astype(np.int64).sum()) > 0
    row, ref_row = port.bench_row(1.0), ref.bench_row(1.0)
    keys = ("ingress_cmds_per_s", "ingress_shed_rate", "ingress_accepted",
            "ingress_submitted", "ingress_dup_dropped", "read_served",
            "read_shed_rate", "read_stale_refused")
    assert {k: row[k] for k in keys} == {k: ref_row[k] for k in keys}
    assert set(devicewatch.bench_tail_keys()) <= set(row)
    assert set(row) == set(ref_row)


def test_durable_plane_matches_reference(tmp_path):
    """The same sequence over durable engines (2 WAL shards, no fsync),
    each dispatch behind a durability barrier (every shard confirmed, as
    the durable engine tests hold the two engines): ``gauges`` carries
    ``wal_pending_steps`` from ``pending_steps``, and settle waits for
    the durable commit; every count, reply and leaf equal."""
    ref_eng, port_eng = _engines((str(tmp_path / "r"), str(tmp_path / "p")))
    try:
        ref, port, replies = _planes(ref_eng, port_eng)
        g = port.gauges()
        assert "wal_pending_steps" in g
        def barrier():
            for e in (ref_eng, port_eng):
                e._dur.flush_all()

        for plane in (ref, port):
            for name in ("submit", "drain"):
                def call(*a, _fn=getattr(plane.driver, name), **kw):
                    barrier()
                    return _fn(*a, **kw)
                setattr(plane.driver, name, call)

        _drive(ref, port, replies, np.random.default_rng(1), waves=8,
               barrier=barrier)
        port_eng._dur.flush_all()
        ref_eng._dur.flush_all()
        assert port_eng._dur.pending_steps() == \
            ref_eng._dur.pending_steps() == 0
        assert_same(ref_eng, port_eng, what="durable final")
    finally:
        ref_eng.close()
        port_eng.close()


def test_bench_tail_keys_and_refusals():
    """``bench_tail_keys`` carries the reference's keys (no card here:
    no peak memory); shardings for an engine that is not sharded are
    refused."""
    keys = devicewatch.bench_tail_keys(commands=10)
    assert set(keys) == {"n_compiles", "n_recompiles", "compile_time_s",
                         "transfer_bytes", "peak_live_bytes",
                         "transfer_bytes_per_cmd"}
    assert keys["peak_live_bytes"] == 0 or torch.cuda.is_initialized()
    eng = port_lockstep.LockstepEngine(CounterMachine(), 4, 3, device="cpu")
    with pytest.raises(ValueError, match="not sharded"):
        IngressPlane(eng, shardings={})
    assert eng._ingress is None
