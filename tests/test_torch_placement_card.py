"""The port's placement failover soak on the card (a ``cuda`` test; this
file imports neither JAX nor the reference): the reference test's size,
both hosts and the adopted victim's recovery on the card, held to the
soak's exactly-once oracle.  ``tests/test_torch_placement.py`` holds the
CPU run against the reference's soak."""
import pytest
import torch

from ra_tpu_torch.placement import run_failover_soak


@pytest.mark.cuda
def test_failover_soak_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    row = run_failover_soak(
        0, conns=4, sessions_per_conn=2, lanes=8, waves=4, wave_ops=200,
        kill_wave=2, data_dir=str(tmp_path), recovery_bar=60.0)
    assert row["failover_lost_acked"] == row["failover_double_applied"] == 0
    assert row["migrations"] >= 1 and row["detector"]["downs"] == 1
    assert row["rehomed_sessions"] == 8
    assert row["host"]["device_name"] == torch.cuda.get_device_name(0)
