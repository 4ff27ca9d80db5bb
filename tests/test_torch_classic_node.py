"""The port's classic plane end to end (``RaNode``, ``LocalRouter``,
``RaSystem``, the ``api`` verbs) against the reference's.

* The README quickstart in both packages: three nodes, each with its own
  ``RaSystem``, a ``KvMachine`` cluster and one seeded script of puts and
  linearizable reads.  Every reply, each member's final machine state
  and its committed log are equal.
* The verbs ``members``, ``start_server``/``add_member``/
  ``remove_member``, ``stop_server``, ``system.recover_servers`` and
  ``restart_server``, and the node-level errors, give equal results.
* ``RegisterMachine``, ``JitKvMachine`` and ``JitFifoMachine(capacity=16)``
  run unchanged on the classic path: twins of the reference's three
  ``test_same_machine_on_classic_path`` tests, the port on the CPU.  Their
  ``cuda`` twins, in ``tests/test_torch_classic_card.py`` (no JAX there),
  hold the card's run against the port's CPU run.

Elections are triggered, not waited for (long election timeouts), so no
result depends on wall-clock timing.
"""

import numpy as np
import pytest

import ra_tpu
import ra_tpu.codec as ref_codec
import ra_tpu.core.types as ref_types
from ra_tpu.models import kv as ref_kv
from ra_tpu.models.jit_fifo import JitFifoMachine as RefFifo
from ra_tpu.models.jit_fifo import query_depth as ref_query_depth
from ra_tpu.models.jit_kv import JitKvMachine as RefJitKv
from ra_tpu.models.jit_kv import query_kv as ref_query_kv
from ra_tpu.models.registers import RegisterMachine as RefRegisters
from ra_tpu.models.registers import query_registers as ref_query_registers
from ra_tpu_torch.models.jit_fifo import JitFifoMachine, query_depth
from ra_tpu_torch.models.jit_kv import JitKvMachine, query_kv
from ra_tpu_torch.models.registers import RegisterMachine, query_registers

from test_torch_classic_card import PORT, SLOW_ELECTION, Deployment, \
    classic_run, jit_fifo_script, jit_kv_script, registers_script
from test_torch_classic_core import log_image, norm

REF = dict(ra=ra_tpu, types=ref_types, codec=ref_codec, kv=ref_kv,
           system=ra_tpu.RaSystem, node_kw={})

def quickstart(pkg, base, seed):
    """The README quickstart with a seeded script of puts and reads."""
    d = Deployment(pkg, base, lambda: pkg["kv"].KvMachine(
        snapshot_interval=16))
    ra = d.ra
    rng = np.random.default_rng(seed)
    replies = []
    try:
        for i in range(60):
            key = f"k{int(rng.integers(8))}"
            if rng.random() < 0.7:
                res = ra.process_command(d.leader, ("put", key, i),
                                         router=d.router)
                replies.append(("put", res.index, norm(res.reply)))
            else:
                res = ra.consistent_query(d.leader,
                                          pkg["kv"].query_get(key),
                                          router=d.router)
                replies.append(("get", norm(res.reply)))
        commit = d.settle()
        members = {s.name: (norm(d.server(s).machine_state),
                            [e for e in log_image(d.server(s), pkg["codec"])
                             if e[0] <= commit])
                   for s in d.sids}
        return replies, members, d.leader.name
    finally:
        d.close()


def test_readme_quickstart_matches_reference(tmp_path):
    want = quickstart(REF, str(tmp_path / "ref"), 4)
    got = quickstart(PORT, str(tmp_path / "port"), 4)
    assert got == want
    assert any(r[0] == "get" and r[1] is not None for r in got[0])


def verbs_transcript(pkg, base):
    """members / start_server + add_member / remove_member / stop_server
    / recover_servers / restart_server, and the node-level errors, as a
    list of normalised results."""
    d = Deployment(pkg, base, lambda: pkg["kv"].KvMachine())
    ra, t, r = d.ra, d.t, d.router
    out = []

    def members(sid):
        return sorted(s.name for s in ra.members(sid, router=r))
    try:
        ra.process_command(d.leader, ("put", "a", 1), router=r)
        out.append(("members", members(d.leader)))
        new = t.ServerId("m4", "node3")
        ra.start_server("kv", pkg["kv"].KvMachine, new, d.sids + [new],
                        router=r, **SLOW_ELECTION)
        res = ra.add_member(d.leader, new, router=r)
        out.append(("add", type(res).__name__, members(d.leader)))
        d.settle(d.sids + [new])
        out.append(("m4 state", norm(d.server(new).machine_state)))
        res = ra.remove_member(d.leader, new, router=r)
        out.append(("remove", type(res).__name__, members(d.leader)))
        follower = next(s for s in d.sids if s != d.leader)
        ra.stop_server(follower, router=r)
        out.append(("stopped", follower.name in
                    d.nodes[follower.node].shells))
        ra.process_command(d.leader, ("put", "b", 2), router=r)
        got = d.systems[follower.node].recover_servers(
            d.nodes[follower.node], lambda c, s: pkg["kv"].KvMachine())
        out.append(("recovered", sorted(s.name for s in got)))
        d.settle()
        out.append(("follower state",
                    norm(d.server(follower).machine_state)))
        ra.restart_server(follower, router=r)
        d.settle()
        out.append(("restarted", norm(d.server(follower).machine_state)))
        # node-level errors
        node1 = d.nodes["node1"]
        for fn in (lambda: ra.restart_server(t.ServerId("nope", "node1"),
                                             router=r),
                   lambda: node1._control_restart({"name": "nope"}),
                   lambda: ra.start_server("kv", pkg["kv"].KvMachine,
                                           d.sids[0], d.sids, router=r),
                   lambda: ra.members(t.ServerId("m1", "node9"), router=r),
                   lambda: ra.process_command(t.ServerId("nope", "node1"),
                                              1, router=r, timeout=0.3)):
            try:
                out.append(("result", norm(fn())))
            except Exception as exc:  # noqa: BLE001 -- the error is the result
                out.append((type(exc).__name__, str(exc)))
        return out
    finally:
        d.close()


def test_verbs_and_node_errors_match_reference(tmp_path):
    want = verbs_transcript(REF, str(tmp_path / "ref"))
    got = verbs_transcript(PORT, str(tmp_path / "port"))
    assert got == want
    assert ("stopped", False) in got and ("recovered", []) not in got


# -- JitMachines on the classic path ----------------------------------------

CASES = {
    "registers": (lambda: RefRegisters(n_slots=4),
                  lambda: RegisterMachine(n_slots=4), registers_script,
                  ref_query_registers, query_registers,
                  [0, 7, 1, [0, 42, 0, 0]]),
    "jit_kv": (lambda: RefJitKv(n_keys=8), lambda: JitKvMachine(n_keys=8),
               jit_kv_script, ref_query_kv, query_kv,
               [(1, None), (1, 9), (1, 11), {3: 11}]),
    "jit_fifo": (lambda: RefFifo(capacity=16),
                 lambda: JitFifoMachine(capacity=16), jit_fifo_script,
                 ref_query_depth, query_depth, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_machine_on_classic_path_matches_reference(name):
    ref_f, port_f, script, ref_q, port_q, expect = CASES[name]
    want = classic_run(REF, ref_f, script, ref_q, state=norm)
    got = classic_run(PORT, port_f, script, port_q, state=norm)
    assert got[0] == want[0]
    if expect is not None:
        assert got[0] == expect
    assert got[1] == want[1]
    assert got[1][0] == got[1][1] == got[1][2]
