"""The port's classic Raft core against the reference's, event by event.

``PortSimCluster`` is the twin of ``tests/harness.py::SimCluster`` over
the port's ``RaServer`` and ``MemoryLog``.  Seeded scripts (elections with
pre-vote, replication, follower catch-up, partitions, membership join and
leave, snapshots through release cursors and their install on a lagging
follower, leadership transfer, consistent queries, a machine version bump)
go through both harnesses in lockstep; after every delivered message each
server's raft state, term, vote, commit index, applied index, log (index,
term and codec image), machine state and the effects it emitted must be
equal, classes compared by name and fields.

Also the codec: the golden USER v1 corpus of ``tests/test_codec.py`` is
byte-exact through the port, images cross between the packages, and the
port reads the reference's FALLBACK pickles through ``convert.loads``
while refusing, by name, a reference path it has no counterpart for and a
JAX array.
"""
import dataclasses
import enum
import pickle
import uuid
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ra_tpu.codec as ref_codec
import ra_tpu.core.machine as ref_machine
import ra_tpu.core.types as ref_types
import ra_tpu.metrics as ref_metrics
import ra_tpu_torch.codec as port_codec
import ra_tpu_torch.core.machine as port_machine
import ra_tpu_torch.core.types as port_types
from ra_tpu_torch import convert, metrics
from ra_tpu_torch.core.server import RaServer
from ra_tpu_torch.log.memory import MemoryLog

from harness import SimCluster
from test_codec import GOLDEN_V1


# -- normalisation: classes by name and fields -------------------------------

def norm(x):
    """A plain, package-free image of ``x`` for equality."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if isinstance(x, (list, tuple, deque)):
        return (type(x).__name__, [norm(v) for v in x])
    if isinstance(x, dict):
        return ("dict", sorted((repr(norm(k)), norm(v))
                               for k, v in x.items()))
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(norm(v)) for v in x))
    if isinstance(x, torch.Tensor):
        return ("array", str(x.dtype).split(".")[-1], x.cpu().tolist())
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax"):
        a = np.asarray(x)
        return ("array", str(a.dtype), a.tolist())
    if isinstance(x, (int, float, str, bytes, bool, type(None))):
        return x
    if callable(x) and hasattr(x, "__qualname__"):
        return ("fn", x.__qualname__)
    if hasattr(x, "__dict__"):
        return (type(x).__name__, norm(vars(x)))
    return repr(x)


def log_image(srv, codec):
    """(idx, term, image) for every entry of ``srv``'s log: a USER image
    byte for byte, any other record by its decoded value (a FALLBACK
    pickle names its package)."""
    log = srv.log
    out = []
    for i in range(log.first_index(), log.last_index_term().index + 1):
        e = log.fetch(i)
        if e is None:
            out.append((i, None))
            continue
        img = codec.encode_command(e.command)
        out.append((e.index, e.term,
                    img if img[0] == codec.TAG_USER
                    else norm(codec.decode_command(img))))
    return out


# -- the port's SimCluster twin ----------------------------------------------

def mk_ids(types, n):
    return [types.ServerId(f"s{i+1}", f"node{i+1}") for i in range(n)]


class PortSimCluster:
    """Synchronous router between N port ``RaServer`` cores: the twin of
    ``harness.SimCluster`` (same routing, effect handling and order)."""

    def __init__(self, n=3, machine_factory=None, auto_written=True,
                 snapshot_chunk_size=64, initial_count=None):
        t = port_types
        self.ids = mk_ids(t, n)
        if machine_factory is None:
            machine_factory = lambda: port_machine.SimpleMachine(  # noqa: E731
                lambda cmd, st: st + cmd, 0)
        self.servers = {}
        self.queues = {sid: deque() for sid in self.ids}
        self.replies, self.notifies = [], []
        self.timer_kinds = {}
        self.dropped = set()
        self.snapshot_chunk_size = snapshot_chunk_size
        initial = tuple(self.ids[:initial_count]
                        if initial_count else self.ids)
        for sid in self.ids:
            cfg = t.ServerConfig(server_id=sid, uid=f"uid_{sid.name}",
                                 cluster_name="simcluster",
                                 initial_members=initial,
                                 machine=machine_factory())
            srv = RaServer(cfg, MemoryLog(auto_written=auto_written))
            srv.recover()
            self.servers[sid] = srv
            self.timer_kinds[sid] = None

    def handle(self, sid, event):
        srv = self.servers[sid]
        self._process_effects(sid, srv.handle(event))
        for evt in srv.log.take_events():
            self._process_effects(sid, srv.handle(evt))

    def _process_effects(self, sid, effects):
        t = port_types
        srv = self.servers[sid]
        for eff in effects:
            if isinstance(eff, t.SendRpc):
                self._send(sid, eff.to, eff.msg)
            elif isinstance(eff, t.SendVoteRequests):
                for to, msg in eff.requests:
                    self._send(sid, to, msg)
            elif isinstance(eff, t.NextEvent):
                self._process_effects(sid, srv.handle(eff.event))
            elif isinstance(eff, t.Reply):
                self.replies.append((sid, eff))
            elif isinstance(eff, t.Notify):
                self.notifies.append((sid, eff))
            elif isinstance(eff, t.StartElectionTimeout):
                self.timer_kinds[sid] = eff.kind
            elif isinstance(eff, t.CancelElectionTimeout):
                self.timer_kinds[sid] = None
            elif isinstance(eff, (t.ReleaseCursor, t.Checkpoint,
                                  t.PromoteCheckpoint)):
                self._process_effects(sid, srv.handle_machine_effect(eff))
            elif isinstance(eff, t.SendSnapshot):
                self._send_snapshot(sid, eff)

    def _send(self, src, dst, msg):
        if (src, dst) not in self.dropped:
            self.queues[dst].append(msg)

    def _send_snapshot(self, src, eff):
        srv = self.servers[src]
        snap = srv.log.snapshot()
        if snap is None:
            return
        meta, data = snap
        leader_id, term = eff.id_term
        chunks = list(srv.log.snapshot_module.chunks(
            data, self.snapshot_chunk_size)) or [b""]
        for i, chunk in enumerate(chunks):
            flag = "last" if i == len(chunks) - 1 else "next"
            self._send(src, eff.to, port_types.InstallSnapshotRpc(
                term=term, leader_id=leader_id, meta=meta,
                chunk_number=i + 1, chunk_flag=flag, data=chunk,
                token=eff.token))

    def step(self):
        for sid in self.ids:
            if self.queues[sid]:
                self.handle(sid, self.queues[sid].popleft())
                return True
        return False

    def leader_index(self):
        for k, sid in enumerate(self.ids):
            if self.servers[sid].raft_state.value == "leader":
                return k
        return None

    def isolate(self, sid):
        for other in self.ids:
            if other != sid:
                self.dropped |= {(sid, other), (other, sid)}

    def heal(self):
        self.dropped.clear()


class _Recording:
    """Keeps every effects list a server emitted, normalised."""

    def __init__(self, *a, **kw):
        self.effects_log = []
        super().__init__(*a, **kw)

    def _process_effects(self, sid, effects):
        self.effects_log.append((sid.name, norm(effects)))
        super()._process_effects(sid, effects)


class RefSim(_Recording, SimCluster):
    pass


class PortSim(_Recording, PortSimCluster):
    pass


# -- machines, made alike in each package ------------------------------------

def query_state(state):
    return state


def snap_counter(pkg_machine, pkg_types, every):
    class SnapCounter(pkg_machine.Machine):
        """Adds commands; releases the log every ``every`` indexes."""

        def init(self, config):
            return 0

        def apply(self, meta, command, state):
            new = state + command
            effs = [pkg_types.ReleaseCursor(meta.index, new)] \
                if meta.index % every == 0 else []
            return new, new, effs
    return SnapCounter


def versioned(pkg_machine, upgraded):
    class CounterV0(pkg_machine.Machine):
        version = 0

        def init(self, config):
            return 0

        def apply(self, meta, command, state):
            return state + command, state + command, []

    class CounterV1(pkg_machine.Machine):
        version = 1

        def __init__(self):
            self._v0 = CounterV0()

        def init(self, config):
            return 0

        def which_module(self, version):
            return self._v0 if version == 0 else self

        def apply(self, meta, command, state):
            if isinstance(command, tuple) and command[0] == "machine_version":
                return ("v1", state, meta.index), None, []
            tag, base, at = state if isinstance(state, tuple) else \
                ("v1", state, None)
            return (tag, base + 2 * command, at), base + 2 * command, []
    calls = iter(range(99))
    return lambda: CounterV1() if next(calls) in upgraded else CounterV0()


# -- both harnesses, event by event -----------------------------------------

class Tokens:
    """Deterministic ``uuid.uuid4`` for pre-vote tokens, replayed for the
    second package so both mint the same sequence."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return uuid.UUID(int=self.n)


class Twin:
    def __init__(self, monkeypatch, n, ref_factory, port_factory,
                 initial_count=None):
        self.tokens = Tokens()
        monkeypatch.setattr(uuid, "uuid4", self.tokens)
        kw = dict(initial_count=initial_count, snapshot_chunk_size=16)
        self.ref = RefSim(n, machine_factory=ref_factory, **kw)
        self.port = PortSim(n, machine_factory=port_factory, **kw)
        self.events = 0
        self.compare("init")

    def both(self, fn):
        start = self.tokens.n
        r = fn(self.ref, ref_types)
        after = self.tokens.n
        self.tokens.n = start
        p = fn(self.port, port_types)
        assert self.tokens.n == after
        return r, p

    def compare(self, what):
        self.events += 1
        ref, port = self.ref, self.port
        for rs, ps in zip(ref.ids, port.ids):
            a, b = ref.servers[rs], port.servers[ps]
            for f in ("current_term", "commit_index", "last_applied"):
                assert getattr(a, f) == getattr(b, f), (what, rs.name, f)
            assert a.raft_state.value == b.raft_state.value, (what, rs.name)
            assert norm(a.voted_for) == norm(b.voted_for), (what, rs.name)
            assert norm(a.machine_state) == norm(b.machine_state), \
                (what, rs.name)
            assert log_image(a, ref_codec) == log_image(b, port_codec), \
                (what, rs.name)
        assert ref.effects_log == port.effects_log, what
        assert norm([r for _s, r in ref.replies]) == \
            norm([r for _s, r in port.replies]), what
        ref.effects_log.clear()
        port.effects_log.clear()

    def handle(self, i, make_event):
        self.both(lambda c, t: c.handle(c.ids[i], make_event(c, t)))
        self.compare(("handle", i))
        self.run()

    def run(self, max_steps=5000):
        for _ in range(max_steps):
            r, p = self.both(lambda c, t: c.step())
            assert r == p
            self.compare("step")
            if not r:
                return
        raise RuntimeError("simulation did not quiesce")


def run_script(twin, rng, n_events, n_members, spare=None):
    """Seeded events: timeouts (pre-vote elections), commands at any
    member (redirects included), ticks (heartbeats, catch-up), isolation
    and healing, consistent queries, leadership transfers and, with a
    ``spare`` member, joins and leaves."""
    kinds = ["timeout", "cmd", "cmd", "cmd", "tick", "tick", "isolate",
             "heal", "query", "transfer"]
    if spare is not None:
        kinds += ["join", "leave"]
    for _ in range(n_events):
        kind = kinds[rng.integers(len(kinds))]
        i = int(rng.integers(n_members))
        if kind == "timeout":
            twin.handle(i, lambda c, t: t.ElectionTimeout())
        elif kind == "cmd":
            # most commands reach the leader; the rest are redirected
            v = int(rng.integers(1, 50))
            lead = twin.port.leader_index()
            if lead is not None and rng.random() < 0.8:
                i = lead
            twin.handle(i, lambda c, t: t.CommandEvent(
                t.UserCommand(v), from_=f"client{v}"))
        elif kind == "tick":
            twin.handle(i, lambda c, t: t.TickEvent())
        elif kind == "isolate":
            twin.both(lambda c, t: c.isolate(c.ids[i]))
        elif kind == "heal":
            twin.both(lambda c, t: c.heal())
        elif kind == "query":
            twin.handle(i, lambda c, t: t.ConsistentQueryEvent(
                query_state, from_="qclient"))
        elif kind == "transfer":
            j = int(rng.integers(n_members))
            twin.handle(i, lambda c, t: t.TransferLeadershipEvent(
                c.ids[j], from_="tclient"))
        elif kind == "join":
            twin.handle(i, lambda c, t: t.CommandEvent(
                t.JoinCommand(c.ids[spare]), from_="jclient"))
        elif kind == "leave":
            twin.handle(i, lambda c, t: t.CommandEvent(
                t.LeaveCommand(c.ids[spare]), from_="lclient"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_matches_reference(monkeypatch, seed):
    """Elections, replication, partitions, catch-up, snapshot installs,
    transfers, queries, joins and leaves: equal after every event."""
    rng = np.random.default_rng(seed)
    twin = Twin(monkeypatch, 4,
                snap_counter(ref_machine, ref_types, 7),
                snap_counter(port_machine, port_types, 7),
                initial_count=3)
    twin.handle(0, lambda c, t: t.ElectionTimeout())
    run_script(twin, rng, 70, 4, spare=3)
    # heal and settle, so the scripts end in one converged cluster
    twin.both(lambda c, t: c.heal())
    for k in range(4):
        twin.handle(k, lambda c, t: t.TickEvent())
    assert twin.events > 200


def test_snapshot_install_on_lagging_follower(monkeypatch):
    """An isolated follower falls behind a released log and is brought
    back by a chunked snapshot install: equal after every chunk."""
    twin = Twin(monkeypatch, 3, snap_counter(ref_machine, ref_types, 3),
                snap_counter(port_machine, port_types, 3))
    twin.handle(0, lambda c, t: t.ElectionTimeout())
    twin.both(lambda c, t: c.isolate(c.ids[2]))
    for v in range(1, 12):
        twin.handle(0, lambda c, t: t.CommandEvent(t.UserCommand(v)))
    twin.both(lambda c, t: c.heal())
    twin.handle(0, lambda c, t: t.TickEvent())
    s3r, s3p = twin.ref.servers[twin.ref.ids[2]], \
        twin.port.servers[twin.port.ids[2]]
    assert s3r.log.snapshot_index_term().index > 0
    assert s3p.machine_state == s3r.machine_state == 66


def test_machine_version_bump_matches_reference(monkeypatch):
    """A rolling upgrade: two v1 members and one v0; the v1 leader's noop
    carries the bump, the v0 member stalls its apply fold."""
    twin = Twin(monkeypatch, 3, versioned(ref_machine, (0, 1)),
                versioned(port_machine, (0, 1)))
    twin.handle(0, lambda c, t: t.ElectionTimeout())
    for v in (5, 6):
        twin.handle(0, lambda c, t: t.CommandEvent(t.UserCommand(v)))
    twin.handle(2, lambda c, t: t.ElectionTimeout())
    twin.handle(0, lambda c, t: t.TickEvent())
    srv = twin.port.servers[twin.port.ids[0]]
    assert srv.effective_machine_version == 1
    assert srv.machine_state[:2] == ("v1", 22)


# -- codec ------------------------------------------------------------------

def _port_args(args):
    data, rm, corr, notify, from_, reply_from = args
    return (data, port_types.ReplyMode[rm.name], corr, notify, from_,
            reply_from)


@pytest.mark.parametrize("name,args,image", GOLDEN_V1,
                         ids=[g[0] for g in GOLDEN_V1])
def test_golden_corpus_byte_exact_and_crosses(name, args, image):
    assert port_codec.encode_user(*_port_args(args)) == image, name
    got = port_codec.decode_command(image)
    assert type(got) is port_types.UserCommand
    assert norm(got) == norm(ref_codec.decode_command(image))
    assert port_codec.CODEC_VERSION == ref_codec.CODEC_VERSION == 1


def test_seeded_images_cross_between_packages():
    rng = np.random.default_rng(5)
    for _ in range(200):
        data = [int(rng.integers(-2 ** 40, 2 ** 40)),
                bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                   dtype=np.uint8)),
                ("put", f"k{int(rng.integers(9))}", int(rng.integers(99))),
                None][int(rng.integers(4))]
        rm = list(ref_types.ReplyMode)[int(rng.integers(4))]
        corr = int(rng.integers(1000)) if rng.random() < 0.5 else None
        ref_cmd = ref_types.UserCommand(data, reply_mode=rm,
                                        correlation=corr)
        port_cmd = port_types.UserCommand(
            data, reply_mode=port_types.ReplyMode[rm.name],
            correlation=corr)
        img = ref_codec.encode_command(ref_cmd)
        assert port_codec.encode_command(port_cmd) == img
        assert norm(port_codec.decode_command(img)) == norm(ref_cmd)
        assert norm(ref_codec.decode_command(
            port_codec.encode_command(port_cmd))) == norm(port_cmd)


def test_reference_fallback_pickles_read_through_convert():
    """A reference FALLBACK record (a membership command) decodes in the
    port as the port's class, as does a ported reference class; a JAX
    array reads as an equal tensor; a reference name the port lacks, and
    any other JAX name, are refused by name."""
    sid = ref_types.ServerId("s4", "node4")
    img = ref_codec.encode_command(ref_types.JoinCommand(sid))
    assert img[0] == ref_codec.TAG_FALLBACK
    got = port_codec.decode_command(img)
    assert type(got) is port_types.JoinCommand
    assert norm(got) == norm(ref_types.JoinCommand(sid))

    from ra_tpu.placement.geo import run_geo_soak
    from ra_tpu.transport.tcp import TcpRouter
    from ra_tpu.utils.jaxenv import force_platform_from_env
    from ra_tpu_torch.placement import geo as port_geo
    from ra_tpu_torch.transport import tcp as port_tcp
    with pytest.raises(pickle.UnpicklingError,
                       match="ra_tpu.utils.jaxenv.force_platform_from_env"):
        convert.loads(pickle.dumps(force_platform_from_env))
    assert convert.loads(pickle.dumps(run_geo_soak)) is port_geo.run_geo_soak
    # a ported reference class reads as the port's
    assert convert.loads(pickle.dumps(TcpRouter)) is port_tcp.TcpRouter
    arrays = {"mac": jnp.asarray([7, -2 ** 31, 2 ** 31 - 1], jnp.int32),
              "flag": jnp.asarray(True), "clock": jnp.int32(5)}
    back = convert.loads(pickle.dumps(arrays))
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert isinstance(back[k], torch.Tensor), k
        assert back[k].numpy().dtype == np.asarray(v).dtype, k
        assert np.array_equal(back[k].numpy(), np.asarray(v)), k
    with pytest.raises(pickle.UnpicklingError, match="JAX"):
        convert.loads(pickle.dumps(jnp.int32))
    # the port's own pickles read back unchanged
    own = port_types.ServerId("a", "b")
    assert convert.loads(pickle.dumps(own)) == own


def test_field_registry_matches_reference():
    for group, fields in ref_metrics.FIELD_REGISTRY.items():
        assert metrics.FIELD_REGISTRY[group] == fields, group
    c = metrics.Counters()
    c.new("u", metrics.SERVER_FIELDS)
    c.incr("u", "commands", 3)
    c.incr("u", "no_such_field")
    assert c.fetch("u")["commands"] == 3 and c.self_metrics() == \
        {"telemetry_dropped": 1}
