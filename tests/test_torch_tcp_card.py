"""The classic plane across OS processes with its machine state on the
card (``cuda`` tests; this file imports neither JAX nor the reference).

Three spawned member processes (``chip_smoke.py``'s ``TcpCluster``), each
a RaNode behind a TcpRouter, run a ``JitKvMachine(16)`` cluster on the
card (``device=None``) and again on the CPU: one seeded script of puts,
gets, deletes and compare-and-sets through ``process_command`` over TCP
gives equal replies, and every member's state, read back, lies on the
card and equals the CPU run's.
"""
import numpy as np
import pytest

from chip_smoke import TcpCluster
from test_torch_classic_card import cuda_device  # noqa: F401


def kv_over_tcp(device):
    """The script on a fresh cluster: (replies, each member's state)."""
    rng = np.random.default_rng(14)
    f = TcpCluster(["tc1", "tc2", "tc3"], device=device)
    try:
        f.start("tcp", "kv16", election_timeout_ms=500)
        f.call("tc1", "elect", "tcp")
        leader = f.leader("tcp")
        replies = []
        for _ in range(60):
            k, v, op = (int(x) for x in rng.integers(0, [16, 2 ** 31 - 1, 4]))
            cmd = [("put", k, v), ("get", k), ("delete", k),
                   ("cas", k, v & 1 and -1, v)][op]
            replies.append(f.call(leader, "command", "tcp", cmd, 15.0)[0])
        return replies, [st["state"] for st in f.states("tcp").values()]
    finally:
        f.stop()


@pytest.mark.cuda
def test_jit_kv_cluster_over_tcp_on_card(cuda_device):  # noqa: F811
    card = kv_over_tcp(None)
    cpu = kv_over_tcp("cpu")
    assert {st[0] for st in card[1]} == {"cuda"}
    assert {st[0] for st in cpu[1]} == {"cpu"}
    assert card[0] == cpu[0]
    assert [st[1:] for st in card[1]] == [st[1:] for st in cpu[1]]
    assert any(x >= 0 for x in card[1][0][2])
