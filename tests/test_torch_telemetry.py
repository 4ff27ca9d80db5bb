"""The port's telemetry plane against the JAX reference: the on-device
summary (``telemetry_summary_fn``), the asynchronous ``TelemetrySampler``
riding step and superstep dispatches, ``PhaseStats``, the field
registries, and the transfer ledger of the sampler's harvest.  Inputs are
seeded numpy; integer and float32 results are compared exactly, dtypes
included.  ``torch.topk`` and ``lax.top_k`` break ties differently, so
the offender lanes are compared by their scores.  A float32 sum of
integers is exact in any order while it stays below 2^24; past that the
two engines' summation orders round differently, and such totals are
compared within n float32 ulps of the sum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu import metrics as ref_metrics
from ra_tpu.devicewatch import WATCH as REF_WATCH
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu.telemetry import PhaseStats as RefPhaseStats
from ra_tpu.telemetry import TelemetrySampler as RefSampler
from ra_tpu_torch import devicewatch, metrics
from ra_tpu_torch.engine import LockstepEngine, lockstep
from ra_tpu_torch.models import CounterMachine
from ra_tpu_torch.readback import Readback
from ra_tpu_torch.telemetry import PhaseStats, TelemetrySampler

TOP = ("top_lanes", "top_commit_lag", "top_apply_lag", "top_stall_steps")


def seeded_telemetry(n, seed, total_hi):
    """int32 LaneTelemetry leaves with many ties (narrow value ranges),
    negative and bucket-edge lags, stalled lanes, and [N] totals below
    ``total_hi``."""
    rng = np.random.default_rng(seed)
    lag = rng.choice([-3, 0, 0, 1, 2, 3, 4, 7, 8, 15, 16, 1000, 70000], n)
    leaves = {
        "elections_requested": rng.integers(0, 4, n),
        "elections_won": rng.integers(0, 3, n),
        "leader_changes": rng.integers(0, 3, n),
        "leader_age": rng.integers(0, 50, n),
        "commit_lag": lag,
        "apply_lag": rng.integers(0, 5, n),
        "stall_steps": rng.choice([0, 0, 0, 3, 8, 9, 40000], n),
        "steps": np.full(n, 37),
    }
    leaves = {k: v.astype(np.int32) for k, v in leaves.items()}
    totals = [rng.integers(0, total_hi, n).astype(np.int32)
              for _ in range(5)]
    return leaves, totals


def summaries(n, seed, geometry, total_hi):
    leaves, totals = seeded_telemetry(n, seed, total_hi)
    ref_fn = ref_lockstep.telemetry_summary_fn(*geometry)
    want = ref_fn(ref_lockstep.LaneTelemetry(
        **{k: jnp.asarray(v) for k, v in leaves.items()}),
        jnp.asarray(totals[0]), tuple(jnp.asarray(t) for t in totals[1:]))
    fn = lockstep.telemetry_summary_fn(*geometry)
    got = fn(lockstep.LaneTelemetry(
        **{k: torch.from_numpy(v) for k, v in leaves.items()}),
        torch.from_numpy(totals[0]),
        tuple(torch.from_numpy(t) for t in totals[1:]))
    return leaves, {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def offender_scores(leaves, lanes):
    stall = np.clip(leaves["stall_steps"][lanes], 0, (1 << 15) - 1)
    lag = np.clip(leaves["commit_lag"][lanes] + leaves["apply_lag"][lanes],
                  0, (1 << 15) - 1)
    return stall * (1 << 15) + lag


@pytest.mark.parametrize("n,seed,geometry,total_hi", [
    (64, 0, (8, 16, 8), 1 << 15), (257, 1, (5, 4, 2), 1 << 15),
    (16, 2, (16, 16, 9), 1 << 15), (64, 3, (8, 16, 8), 1 << 30)])
def test_summary_matches_reference(n, seed, geometry, total_hi):
    leaves, want, got = summaries(n, seed, geometry, total_hi)
    assert sorted(got) == sorted(want) == \
        sorted(metrics.TELEMETRY_SUMMARY_FIELDS)
    inexact = {k for k in want if k.endswith("_total")} \
        if n * total_hi > 1 << 24 else set()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if k in inexact:
            np.testing.assert_allclose(got[k], want[k], rtol=n * 2.0 ** -24)
        elif k not in TOP:
            assert np.array_equal(got[k], want[k]), (k, got[k], want[k])
    # offenders by score: the same descending scores, and every top_*
    # gauge is the lane's own value
    np.testing.assert_array_equal(
        offender_scores(leaves, got["top_lanes"]),
        offender_scores(leaves, want["top_lanes"]))
    for k, leaf in (("top_commit_lag", "commit_lag"),
                    ("top_apply_lag", "apply_lag"),
                    ("top_stall_steps", "stall_steps")):
        np.testing.assert_array_equal(got[k], leaves[leaf][got["top_lanes"]])
    assert want["stalled_lanes"] > 0 and want["commit_lag_hist"][-1] > 0


def mk_pair(n=8, p=3):
    kw = dict(ring_capacity=64, max_step_cmds=4)
    return (RefEngine(RefCounter(), n, p, donate=False, **kw),
            LockstepEngine(CounterMachine(), n, p, device="cpu", **kw))


def assert_same_snapshot(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "ts":
            continue
        if k in TOP:
            assert len(got[k]) == len(want[k]), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def test_sampler_superstep_cadence_matches_reference():
    """The fused path ticks the sampler K rounds a dispatch; a K that
    does not divide the cadence carries its overshoot (48 rounds in
    dispatches of 3 at cadence 8: 6 samples)."""
    ref, port = mk_pair()
    rs = RefSampler(ref, cadence_steps=8)
    ps = TelemetrySampler(port, cadence_steps=8)
    assert port._telemetry is ps
    for _ in range(4):
        ref.uniform_superstep(4, 2)
        port.uniform_superstep(4, 2)
    assert ps.counters["samples_started"] == \
        rs.counters["samples_started"] == 2
    snap = ps.drain()
    assert_same_snapshot(snap, rs.drain())
    assert snap["steps"] == 16 and snap["inner_steps_at_sample"] == 16
    assert snap["committed_total"] == port.committed_total()
    for _ in range(16):
        ref.uniform_superstep(3, 1)
        port.uniform_superstep(3, 1)
    assert ps.counters["samples_started"] - 3 == \
        rs.counters["samples_started"] - 3 == 6
    assert_same_snapshot(ps.drain(), rs.drain())
    assert ps.counters["blocking_waits"] == 0   # CPU copies: always ready


def test_sampler_single_step_cadence_and_elections_match_reference():
    ref, port = mk_pair()
    rs = RefSampler(ref, cadence_steps=4)
    ps = TelemetrySampler(port, cadence_steps=4)
    for i in range(10):
        ref.uniform_step(3)
        port.uniform_step(3)
        if i == 5:
            ref.trigger_election([0, 3])
            port.trigger_election([0, 3])
    assert ps.counters["samples_started"] == \
        rs.counters["samples_started"] == 2
    snap = ps.drain()
    assert_same_snapshot(snap, rs.drain())
    assert snap["elections_requested"] == 2 and snap["stalled_lanes"] == 0


def test_sampler_overflow_evicts_oldest_without_blocking(monkeypatch):
    """Copies that have not landed are never waited on in the tick path:
    beyond max_pending the oldest sample is dropped.  On the CPU every
    copy lands at once, so the slow copies are simulated."""
    ref, port = mk_pair()
    rs = RefSampler(ref, cadence_steps=1, max_pending=2)
    ps = TelemetrySampler(port, cadence_steps=1, max_pending=2)
    monkeypatch.setattr(Readback, "is_ready", lambda self: False)
    for _ in range(8):
        ref.uniform_step(1)
        port.uniform_step(1)
    for s in (rs, ps):
        assert s.counters["samples_started"] == 8
        assert s.counters["blocking_waits"] == 0
        assert len(s._pending) <= 2
    assert ps.counters["samples_dropped"] == 6
    assert ps.counters["samples_harvested"] == 0
    snap = ps.drain()                   # the barrier waits, and counts it
    assert ps.counters["blocking_waits"] == 2
    assert ps.counters["samples_harvested"] == 2
    assert ps.counters["samples_dropped"] == 7
    monkeypatch.undo()
    assert_same_snapshot(snap, rs.drain())


def test_sampler_observer_fault_isolation_matches_reference():
    """A raising observer is counted, later observers still run, and
    harvesting goes on."""
    ref, port = mk_pair()
    samplers = (RefSampler(ref, cadence_steps=2),
                TelemetrySampler(port, cadence_steps=2))
    seen = ([], [])
    for s, sink in zip(samplers, seen):
        s.add_observer(lambda _snap: (_ for _ in ()).throw(
            OSError("disk full")))
        s.add_observer(sink.append)
    for _ in range(8):
        ref.uniform_step(1)
        port.uniform_step(1)
    for s in samplers:
        s.drain()
    rs, ps = samplers
    assert ps.counters["observer_errors"] == \
        ps.counters["samples_harvested"] == len(seen[1]) == 5
    assert rs.counters["observer_errors"] >= 1
    assert len(seen[0]) == rs.counters["samples_harvested"]
    assert_same_snapshot(seen[1][-1], seen[0][-1])


def test_phase_stats_overview_matches_reference():
    rng = np.random.default_rng(9)
    ref, port = RefPhaseStats(reservoir=16), PhaseStats(reservoir=16)
    phases = list(metrics.PHASE_FIELDS) + ["bogus"]
    for _ in range(200):
        phase = phases[int(rng.integers(len(phases)))]
        dt = float(rng.exponential(0.004))
        ref.note(phase, dt)
        port.note(phase, dt)
    assert port.overview() == ref.overview()
    ref.reset_reservoirs()
    port.reset_reservoirs()
    assert port.overview() == ref.overview()
    assert port.overview()["dropped"] > 0


def test_registries_match_reference():
    assert metrics.PHASE_FIELDS == ref_metrics.PHASE_FIELDS
    assert metrics.TELEMETRY_SUMMARY_FIELDS == \
        ref_metrics.TELEMETRY_SUMMARY_FIELDS
    assert metrics.FIELD_REGISTRY["phase"] is metrics.PHASE_FIELDS
    for group, fields in metrics.FIELD_REGISTRY.items():
        assert ref_metrics.FIELD_REGISTRY[group] == fields, group


def test_ledger_counts_sampler_harvest_like_reference():
    ref, port = mk_pair()
    r0 = dict(REF_WATCH.sites["sampler_harvest"])
    p0 = dict(devicewatch.WATCH.sites["sampler_harvest"])
    rs = RefSampler(ref, cadence_steps=4)
    ps = TelemetrySampler(port, cadence_steps=4)
    for _ in range(3):
        ref.uniform_superstep(4, 1)
        port.uniform_superstep(4, 1)
    rs.drain()
    ps.drain()
    got = {k: v - p0[k]
           for k, v in devicewatch.WATCH.sites["sampler_harvest"].items()}
    want = {k: v - r0[k] for k, v in REF_WATCH.sites["sampler_harvest"]
            .items()}
    assert got == want
    assert got["d2h_events"] == 4 * len(metrics.TELEMETRY_SUMMARY_FIELDS)
