"""The port's geo survival soak (``ra_tpu_torch/placement/geo.py``) against
the reference's (``ra_tpu/placement/geo.py``), the port's engines on the
CPU: the latency-domain plans each process installs, decision for
decision; the slot budget and the child's argument defaults; the oracle's
expected lane sums; the engine child's state when it reports ready; the
whole soak across four OS processes in each package at the reference's
defaults; and the refusal to start without a card when none was named.
The soak's ``cuda`` test is in ``tests/test_torch_placement_card.py``
(no JAX there)."""
import argparse
import os

import numpy as np
import pytest
import torch

import ra_tpu.placement.geo as ref_geo
import ra_tpu_torch.placement.geo as port_geo
from ra_tpu.placement.host import LaneEngineHost as RefHost
from ra_tpu.wire import DedupCounterMachine as RefDedup
from ra_tpu_torch.convert import state_to_numpy
from test_torch_engine import assert_same_arrays, ref_arrays
from test_torch_slo_autotune import _scoped_port_plans  # noqa: F401

GEO = {"ref": ref_geo, "port": port_geo}
#: the keys on which the port's soak row must equal the reference's
ROW_KEYS = ("geo_lost_acked", "geo_double_applied", "geo_false_migrations",
            "ops", "sessions", "lanes", "migrations", "domain_matrix")
FRAMES = [(peer, cls, direction)
          for peer in ("gf1", "n_engA", "ctl")
          for cls in ("append", "rpc_req", "reply", "ping")
          for direction in ("send", "recv")] * 3


def row_keys(row: dict) -> dict:
    return {**{k: row[k] for k in ROW_KEYS},
            "downs": row["detector"]["downs"]}


@pytest.mark.parametrize("eng_delay", [False, True])
@pytest.mark.parametrize("local", ["ctl", "far", "eng"])
def test_geo_plan_matches_reference(local, eng_delay):
    """One process's plan: the compiled domain matrix and the decisions
    for the same frames to a far follower, an engine node and the parent."""
    out = {}
    for name, geo in GEO.items():
        plan = geo._geo_plan(local, 3, eng_delay=eng_delay)
        try:
            out[name] = (plan.overview()["domain_matrix"],
                         [tuple(vars(plan.decide(*f)).values())
                          for f in FRAMES])
        finally:
            plan.unregister()
    assert out["port"] == out["ref"]
    delayed = {f[0] for f, d in zip(FRAMES, out["port"][1]) if d[1] > 0}
    assert ("gf1" in delayed) == (local == "ctl")


def test_machine_slots_and_child_defaults(monkeypatch):
    for sessions in (1, 24, 48, 2048, 4096):
        for lanes in (1, 16, 1024):
            assert port_geo._machine_slots(sessions, lanes) == \
                ref_geo._machine_slots(sessions, lanes)
    base = ["--ready", "r", "--parent-host", "127.0.0.1",
            "--parent-port", "7"]
    for child in ("engine", "control"):
        seen = {}
        for name, geo in GEO.items():
            for fn in ("_engine_child", "_control_child"):
                monkeypatch.setattr(geo, fn,
                                    lambda a, n=name, f=fn: seen.update(
                                        {n: (f, vars(a))}))
            geo._child_main(["--child", child] + base)
        assert seen["port"][1].pop("device") is None   # None: the card
        assert seen["port"] == seen["ref"]


def test_expected_lane_sums_match_reference():
    rng = np.random.default_rng(14)
    n_ops = 500
    client = argparse.Namespace(
        n_sessions=24, tenants=2, op_state=[2] * n_ops,
        op_sess=rng.integers(0, 24, n_ops).tolist(),
        op_pay=rng.integers(1, 8, n_ops).tolist())
    got = port_geo._expected_lane_sums(client, 16, "geo0/engA")
    want = ref_geo._expected_lane_sums(client, 16, "geo0/engA")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.sum() == sum(client.op_pay)


def test_engine_child_ready_state_matches_reference(tmp_path):
    """What the port's engine child holds when it writes its ready file
    equals what the reference's child has built at that point: every
    engine leaf and the lane sums ``host_lane_sums`` reads."""
    args = argparse.Namespace(
        eid="engA", parent_host="127.0.0.1", parent_port=9, seed=0,
        sessions=24, lanes=16, wal_shards=2, data_dir=str(tmp_path / "p"),
        device="cpu")
    router, node, host, agent = port_geo._engine_stack(args)
    ref = RefHost("engA", str(tmp_path / "r"), machine_factory=lambda:
                  RefDedup(slots=ref_geo._machine_slots(24, 16)),
                  lanes=16, wal_shards=2, max_conns=16, port=0)
    try:
        assert "geo_launches" in node.control_ops
        assert host.engine.device.type == "cpu"
        assert_same_arrays(state_to_numpy(host.engine.state),
                           ref_arrays(ref.engine.state), "ready state")
        lanes = np.arange(16)
        got = np.asarray(host.engine.consistent_read(lanes)["value"])
        want = np.asarray(ref.engine.consistent_read(lanes)["value"])
        assert got.dtype == want.dtype and np.array_equal(got, want)
    finally:
        ref.close()
        host.close()
        node.stop()
        router.stop()


# the victim's WAL threads and sockets die with it by design
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_geo_soak_matches_reference(tmp_path, monkeypatch):
    """The whole soak at the reference's defaults in each package: four
    OS processes each, a delay-only episode, a SIGKILL, the adoption and
    the exactly-once oracle over both engines."""
    # one torch thread a child: at 16 lanes the default pool only spins,
    # about three cores an engine child taken from the rest of the suite
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # the reference's control child writes its ready file into data_dir
    # without creating it
    (tmp_path / "ref").mkdir()
    ref = ref_geo.run_geo_soak(0, data_dir=str(tmp_path / "ref"))
    port = port_geo.run_geo_soak(0, data_dir=str(tmp_path / "port"),
                                 device="cpu")
    assert row_keys(port) == row_keys(ref) == {
        "geo_lost_acked": 0, "geo_double_applied": 0,
        "geo_false_migrations": 0, "ops": 4200, "sessions": 48,
        "lanes": 16, "migrations": 1, "domain_matrix": ["ctl->far"],
        "downs": 1}
    assert port["host"]["device_name"] == "cpu"
    assert port["engine_launches"] == {
        e: {"evaluate_quorum": 0, "commit_phase": 0, "slot_fold": 0,
            "fifo_fold": 0} for e in ("engA", "engB")}


def test_geo_soak_without_card_raises_before_spawning(tmp_path,
                                                      monkeypatch):
    """No device named and no card: the parent raises before it starts a
    child or writes a file."""
    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_geo.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_geo.run_geo_soak(0, data_dir=str(tmp_path))
    assert spawned == [] and os.listdir(tmp_path) == []
