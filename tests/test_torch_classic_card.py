"""JitMachines on the port's classic path, on the card (``cuda`` tests;
this file imports neither JAX nor the reference).

``RegisterMachine``, ``JitKvMachine`` and ``JitFifoMachine(capacity=16)``
run the scripts of the reference's ``test_same_machine_on_classic_path``
tests on three nodes whose machines hold their replica state on the card;
every reply and every member's state equal the port's run of the same
script on the CPU.  A snapshot of a card-held state recovers on the card,
equal to the state before.  ``Deployment`` and the scripts are shared
with ``tests/test_torch_classic_node.py``, which holds the CPU runs
against the reference.
"""
import os
import time

import pytest
import torch

import ra_tpu_torch
import ra_tpu_torch.codec as port_codec
import ra_tpu_torch.core.types as port_types
from ra_tpu_torch.core.machine import ApplyMeta
from ra_tpu_torch.core.server import RaServer
from ra_tpu_torch.models import kv as port_kv
from ra_tpu_torch.models.jit_fifo import JitFifoMachine, query_depth
from ra_tpu_torch.models.jit_kv import JitKvMachine, query_kv
from ra_tpu_torch.models.registers import RegisterMachine, query_registers
from ra_tpu_torch.system import RaSystem

PORT = dict(ra=ra_tpu_torch, types=port_types, codec=port_codec,
            kv=port_kv, system=RaSystem, node_kw={"device": "cpu"})
#: elections are triggered, never waited for
SLOW_ELECTION = dict(election_timeout_ms=5000)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def await_leader(router, sids, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for sid in sids:
            node = router.nodes.get(sid.node)
            shell = node.shells.get(sid.name) if node else None
            if shell and shell.server.raft_state.value == "leader":
                return sid
        time.sleep(0.01)
    raise TimeoutError("no leader elected")


class Deployment:
    """Three nodes on one router, each with its own ``RaSystem`` (or none)
    and one member of a cluster: the README's classic deployment, in
    either package (``pkg`` names its modules)."""

    def __init__(self, pkg, base, factory, name="kv", systems=True,
                 node_kw=None):
        ra, t = pkg["ra"], pkg["types"]
        self.pkg, self.ra, self.t = pkg, ra, t
        self.router = ra.LocalRouter()
        self.sids = [t.ServerId(f"m{i}", f"node{i}") for i in (1, 2, 3)]
        self.systems = {s.node: pkg["system"](os.path.join(base, s.node))
                        for s in self.sids} if systems else {}
        kw = pkg["node_kw"] if node_kw is None else node_kw
        self.nodes = {s.node: ra.RaNode(s.node, router=self.router,
                                        system=self.systems.get(s.node),
                                        **kw)
                      for s in self.sids}
        for sid in self.sids:
            self.nodes[sid.node].start_server(t.ServerConfig(
                server_id=sid, uid=ra.new_uid(sid.name), cluster_name=name,
                initial_members=tuple(self.sids), machine=factory(),
                **SLOW_ELECTION))
        ra.trigger_election(self.sids[0], self.router)
        self.leader = await_leader(self.router, self.sids)

    def server(self, sid):
        return self.nodes[sid.node].shells[sid.name].server

    def settle(self, sids=None, timeout=10.0):
        """Wait until every member applied the leader's commit index."""
        sids = sids or self.sids
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lead = self.server(self.leader).commit_index
            if all(self.server(s).last_applied == lead for s in sids):
                return lead
            time.sleep(0.01)
        raise TimeoutError("members did not converge")

    def close(self):
        for n in self.nodes.values():
            n.stop()
        for s in self.systems.values():
            s.close()


# -- the reference's classic-path scripts -------------------------------------

def registers_script(ra, leader, r, q):
    return [ra.process_command(leader, ("put", 1, 5), router=r).reply,
            ra.process_command(leader, ("add", 1, 2), router=r).reply,
            ra.process_command(leader, ("cas", 1, 7, 42), router=r).reply,
            ra.consistent_query(leader, q, router=r).reply]


def jit_kv_script(ra, leader, r, q):
    return [ra.process_command(leader, ("put", 3, 9), router=r).reply,
            ra.process_command(leader, ("cas", 3, 9, 11), router=r).reply,
            ra.process_command(leader, ("get", 3), router=r).reply,
            ra.consistent_query(leader, q, router=r).reply]


def jit_fifo_script(ra, leader, r, q):
    out = [ra.process_command(leader, ("enqueue", 41), router=r).reply,
           ra.process_command(leader, ("enqueue", 42), router=r).reply]
    mid = ra.process_command(leader, ("dequeue", "unsettled"),
                             router=r).reply
    out += [mid, ra.process_command(leader, ("settle", mid), router=r).reply,
            ra.process_command(leader, ("dequeue", "settled"),
                               router=r).reply,
            int(ra.consistent_query(leader, q, router=r).reply)]
    return out


PORT_CASES = {
    "registers": (lambda: RegisterMachine(n_slots=4), registers_script,
                  query_registers),
    "jit_kv": (lambda: JitKvMachine(n_keys=8), jit_kv_script, query_kv),
    "jit_fifo": (lambda: JitFifoMachine(capacity=16), jit_fifo_script,
                 query_depth),
}


def host_state(x):
    """A machine state as host lists (tensors by dtype name and values)."""
    if isinstance(x, dict):
        return {k: host_state(v) for k, v in sorted(x.items())}
    return (str(x.dtype), x.cpu().tolist())


def classic_run(pkg, factory, script, query, node_kw=None, state=host_state,
                devices=None):
    """The script on a fresh three-node deployment: (replies, each
    member's state); ``devices`` collects the state leaves' devices."""
    d = Deployment(pkg, None, factory, name="jit", systems=False,
                   node_kw=node_kw)
    try:
        replies = script(d.ra, d.leader, d.router, query)
        d.settle()
        states = [d.server(s).machine_state for s in d.sids]
        if devices is not None:
            devices.update(x.device.type for st in states for x in (
                st.values() if isinstance(st, dict) else [st]))
        return replies, [state(st) for st in states]
    finally:
        d.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_same_machine_on_classic_path_on_card(cuda_device, name):
    factory, script, query = PORT_CASES[name]
    want = classic_run(PORT, factory, script, query)
    devices: set = set()
    got = classic_run(PORT, factory, script, query,
                      node_kw={"device": None}, devices=devices)
    assert devices == {"cuda"}
    assert got == want


@pytest.mark.cuda
def test_card_snapshot_recovers_on_card(cuda_device, tmp_path):
    """A snapshot of a card-held JitMachine state, through the durable log
    and a recovered core, comes back on the card, equal."""
    m = JitKvMachine(n_keys=8)
    state = m.init({"device": None})
    for i, cmd in enumerate([("put", 3, 9), ("put", 5, 1),
                             ("cas", 3, 9, 11)], start=1):
        state, _ = m.apply(ApplyMeta(i, 1), cmd, state)
    sid = port_types.ServerId("s1", "n1")
    cfg = port_types.ServerConfig(server_id=sid, uid="u1",
                                  cluster_name="c", initial_members=(sid,),
                                  machine=JitKvMachine(n_keys=8))
    system = RaSystem(str(tmp_path))
    try:
        log = system.log_factory(cfg)
        for i in range(1, 4):
            log.append(port_types.Entry(
                i, 1, port_types.UserCommand(("get", 0))))
        deadline = time.monotonic() + 10
        while log.last_written().index < 3 and \
                time.monotonic() < deadline:
            for e in log.take_events():
                log.handle_written(e)
            time.sleep(0.005)
        log.update_release_cursor(
            3, ((sid, port_types.Membership.VOTER),), 0, state)
    finally:
        system.close()
    system = RaSystem(str(tmp_path))
    try:
        srv = RaServer(cfg, system.log_factory(cfg))
        srv.recover()
        got = srv.machine_state
        assert got.device.type == "cuda"
        assert torch.equal(got, state)
        assert srv.last_applied == 3
    finally:
        system.close()
