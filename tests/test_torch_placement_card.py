"""The port's placement failover soak on the card (a ``cuda`` test; this
file imports neither JAX nor the reference): the reference test's size,
both hosts and the adopted victim's recovery on the card, held to the
soak's exactly-once oracle.  ``tests/test_torch_placement.py`` holds the
CPU run against the reference's soak.  The geo soak (four OS processes,
the engine children's engines on the card) is held against its own CPU
run here; ``tests/test_torch_geo.py`` holds that against the reference.

The soak's disk-fault run is held here for the port alone, on the CPU
and on the card: a torn WAL magic at the adopt and a shard WAL dying
under backpressure stop the reference's run, and the port survives
both."""
import pytest
import torch

from ra_tpu_torch.placement import run_failover_soak, run_geo_soak

SMALL = dict(conns=4, sessions_per_conn=2, lanes=8, waves=4, wave_ops=200,
             kill_wave=2)
#: the disk-fault run's seeds on the CPU.  Which WAL write a fault hits
#: follows the count of writes before it, which timing moves, so no seed
#: hits the torn magic every time: tests/test_torch_wal.py pins that
DISK_FAULT_SEEDS = (1, 2, 5, 1033)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def check_row(row):
    assert row["failover_lost_acked"] == row["failover_double_applied"] == 0
    assert row["migrations"] >= 1 and row["detector"]["downs"] == 1
    assert row["rehomed_sessions"] == 8


@pytest.mark.cuda
def test_failover_soak_on_card(tmp_path):
    dev = card()
    row = run_failover_soak(0, data_dir=str(tmp_path), recovery_bar=60.0,
                            **SMALL)
    check_row(row)
    assert row["host"]["device_name"] == torch.cuda.get_device_name(dev)


# a WAL shard's thread dies on a fault streak on purpose (the supervisor
# restarts it): part of the scenario under test
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("seed", DISK_FAULT_SEEDS)
def test_failover_soak_under_disk_faults(tmp_path, seed):
    check_row(run_failover_soak(seed, data_dir=str(tmp_path), device="cpu",
                                disk_faults=True, **SMALL))


@pytest.mark.cuda
def test_failover_soak_under_disk_faults_on_card(tmp_path):
    """Forty seeds of the disk-fault run on the card, each held to the
    oracle; the failures are gathered so one run names every seed."""
    dev = card()
    failed = {}
    for seed in range(40):
        try:
            check_row(run_failover_soak(
                seed, data_dir=str(tmp_path / str(seed)), device=dev,
                disk_faults=True, **SMALL))
        except Exception as exc:  # noqa: BLE001 — named per seed below
            failed[seed] = repr(exc)[:200]
    assert not failed, failed


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.cuda
def test_geo_soak_on_card_matches_cpu(tmp_path):
    """The geo soak at the reference's defaults with the engine children
    on the card equals its CPU run on the oracle's counts and the
    failover's shape; each engine child launched the commit phase."""
    from ra_tpu_torch.ops import _build
    dev = card()
    _build.build_all()      # one build before two children load it
    rows = {d: run_geo_soak(0, data_dir=str(tmp_path / str(d)), device=d)
            for d in (dev, "cpu")}
    keys = ("geo_lost_acked", "geo_double_applied", "geo_false_migrations",
            "ops", "sessions", "lanes", "migrations", "domain_matrix")
    got = {d: ({k: r[k] for k in keys}, r["detector"]["downs"])
           for d, r in rows.items()}
    assert got[dev] == got["cpu"]
    assert all(n["commit_phase"] > 0
               for n in rows[dev]["engine_launches"].values())
