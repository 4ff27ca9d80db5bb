"""The port's StreamMachine (``ra_tpu_torch/models/stream.py``) against the
JAX reference (``ra_tpu/models/stream.py``): the same numpy-seeded inputs
go through both packages, and every state leaf, reply, query reply and
encoded command must be equal, dtypes included (``np.array_equal``).

* ``jit_apply``, ``jit_query``, ``_batch_fast``, ``sequential_window_fold``
  and ``jit_apply_batch`` (both branches of its fold choice) on random
  windows of every op: tails near 2**31 - 1 and negative, windows wider
  than the ring, bad groups and negative values;
* the lane engine at 16 lanes x 5 members against the reference's, leaf
  for leaf after every step, with reads;
* twins of the reference's stream read-plane cases
  (``tests/test_read_plane.py``): the ``read_lanes`` round trip and the
  linearizable-read oracle, here run on both engines at once;
* on a card only (``cuda`` marker): the stream decoder of
  ``ops/csrc/slot_fold.cu`` against its plain version, the machine's
  ``sequential_window_fold``; and the card's batch fold of a ring of 5
  against the reference's at the int32 edge."""
import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.models import StreamMachine as RefStream
from ra_tpu.models.stream import query_bounds as ref_query_bounds
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.models import StreamMachine
from ra_tpu_torch.models.stream import query_bounds
from ra_tpu_torch.ops import slot_fold
from chip_smoke import STREAM_EDGE as EDGE
from chip_smoke import stream_commands as stream_cmds
from chip_smoke import stream_state, wrap32
from test_torch_machines import assert_tree_equal
from test_torch_engine import assert_same, host_verbs, \
    positional_archives
from test_torch_classic_card import cuda_device  # noqa: F401
from test_torch_dedup import to_port

CPU = torch.device("cpu")
N, P = 6, 3
#: (capacity, groups): the default, a small ring, a ring that is no power
#: of two
SHAPES = [(64, 4), (8, 3), (5, 2)]


@pytest.mark.parametrize("Q,G", SHAPES)
def test_jit_apply_and_query_match_reference(Q, G):
    ref_m, port_m = RefStream(Q, G), StreamMachine(Q, G)
    rng = np.random.default_rng(Q + G)
    rs = stream_state(rng, (N, P), Q, G)
    ps = to_port(rs)
    apply = jax.jit(ref_m.jit_apply)
    for i in range(24):
        cmd = stream_cmds(rng, (N, P), G, clean=False)
        rs, rr = apply({}, jnp.asarray(cmd), rs)
        ps, pr = port_m.jit_apply({}, torch.from_numpy(cmd), ps)
        assert_tree_equal(ps, rs, f"state, command {i}")
        assert_tree_equal(pr, rr, f"reply, command {i}")
        q = np.stack([rng.integers(0, 4, (N, P, 5)),
                      np.where(rng.random((N, P, 5)) < 0.2,
                               rng.choice(EDGE, (N, P, 5)),
                               rng.integers(-3, 2 * Q, (N, P, 5)))],
                     -1).astype(np.int32)
        assert_tree_equal(port_m.jit_query(torch.from_numpy(q), ps),
                          ref_m.jit_query(jnp.asarray(q), rs),
                          f"query, command {i}")


@pytest.mark.parametrize("Q,G", SHAPES)
@pytest.mark.parametrize("A", [1, 40])
def test_window_folds_match_reference(Q, G, A):
    """Clean windows (the fast fold) and mixed ones, A up to 8x the ring:
    the fast fold, the in-order fold and the batch fold's choice between
    them, from states at the int32 edges."""
    ref_m, port_m = RefStream(Q, G), StreamMachine(Q, G)
    rng = np.random.default_rng(Q * 100 + G * 10 + A)
    batch = jax.jit(ref_m.jit_apply_batch)
    for w in range(4):
        clean = w % 2 == 0
        st = stream_state(rng, (N, P), Q, G)
        cmd = np.broadcast_to(stream_cmds(rng, (N, 1, A), G, clean),
                              (N, P, A, 3))
        mask = rng.random((N, P, A)) < 0.85
        index = np.broadcast_to(np.arange(1, A + 1, dtype=np.int32),
                                (N, P, A))
        rmeta = {"index": jnp.asarray(index), "term": jnp.int32(1)}
        pmeta = {"index": torch.from_numpy(index.copy()),
                 "term": torch.tensor(1, dtype=torch.int32)}
        rargs = (jnp.asarray(cmd), jnp.asarray(mask),
                 jax.tree.map(jnp.asarray, st))
        pargs = (torch.from_numpy(cmd.copy()), torch.from_numpy(mask),
                 to_port(st))
        what = f"window {w}, clean {clean}"
        assert_tree_equal(port_m.sequential_window_fold(pmeta, *pargs),
                          ref_m.sequential_window_fold(rmeta, *rargs),
                          f"in-order fold, {what}")
        assert_tree_equal(port_m.jit_apply_batch(pmeta, *pargs),
                          batch(rmeta, *rargs), f"batch fold, {what}")
        if clean:
            assert bool(port_m._fast_ok(pargs[0], pargs[1]))
            assert_tree_equal(port_m._batch_fast(*pargs),
                              ref_m._batch_fast(*rargs),
                              f"fast fold, {what}")


def _composed_fold(Q, G, cmd, keep, st, parts=8):
    """One row's window folded as the card's stream decoder folds it: in
    ``parts`` runs, each from its tail and folded alone into clamp maps of
    the base and cursors, the maps composed in a tree in order; the ring
    takes its last Q appends, or all in order where two share a slot."""
    wrap = lambda x: (x + 2 ** 31) % 2 ** 32 - 2 ** 31  # noqa: E731
    then = lambda f, lo, hi: tuple(min(max(v, lo), hi) for v in f)  # noqa
    A, tail0, buf = len(cmd), int(st["tail"]), [int(v) for v in st["buf"]]
    app = [bool(keep[i]) and cmd[i][0] == 1 and cmd[i][1] >= 0
           for i in range(A)]
    K, per, k, maps = sum(app), -(-A // parts), 0, []
    distinct = Q & (Q - 1) == 0 or tail0 + K - 1 < 2 ** 31
    for j in range(parts):      # maps[j]: the base's, then each cursor's
        tail, m = wrap(tail0 + k), [(-2 ** 31, 2 ** 31 - 1)] * (G + 1)
        for i in range(min(A, j * per), min(A, j * per + per)):
            op, x, y = (int(v) for v in cmd[i])
            if keep[i] and app[i]:
                if distinct and k >= K - Q:
                    buf[tail % Q] = x
                tail, k = wrap(tail + 1), k + 1
            if keep[i] and op == 2 and 0 <= x < G:
                m[x + 1] = then(m[x + 1], max(y, 0), tail)
            elif keep[i] and op == 3:
                m[0] = then(m[0], max(x, 0), tail)
            if keep[i]:
                m[0] = then(m[0], wrap(tail - Q), 2 ** 31 - 1)
        maps.append(m)
    while len(maps) > 1:
        maps = [[then(f, *g) for f, g in zip(a, b)]
                for a, b in zip(maps[::2], maps[1::2])]
    for i in range(A):
        if app[i] and not distinct:
            buf[tail0 % Q], tail0 = int(cmd[i][1]), wrap(tail0 + 1)
    base, *cursors = [then((int(v),) * 2, *f)[0] for v, f in
                      zip([st["base"], *st["cursors"]], maps[0])]
    return {"buf": buf, "tail": wrap(int(st["tail"]) + K), "base": base,
            "cursors": cursors}


@pytest.mark.parametrize("Q,G", SHAPES)
def test_composed_maps_match_reference_fold(Q, G):
    """The stream decoder's algebra on the CPU: each row's window folded
    by composed maps (``_composed_fold``) equals the reference's in-order
    ``jit_apply`` fold, window after window, from tails, bases and cursors
    at the int32 edges, with all-masked, one-command and A > Q windows
    (the last from tails that wrap inside it)."""
    ref_m = RefStream(Q, G)
    fold = jax.jit(ref_m.sequential_window_fold)
    rng = np.random.default_rng(Q + G)
    st = stream_state(rng, (N, P), Q, G)
    for w, (A, keep) in enumerate([(40, 0.85), (40, 0.0), (1, 1.0),
                                   (3 * Q + 7, 0.95)]):
        if w == 3:      # the tail wraps at any point of an append window
            st["tail"] = wrap32(2 ** 31 - 1 - rng.integers(0, A, (N, P)))
        cmd = np.broadcast_to(stream_cmds(rng, (N, 1, A), G, w == 3),
                              (N, P, A, 3))
        mask = rng.random((N, P, A)) < keep
        index = np.ones((N, P, A), np.int32)
        want = {k: np.array(v) for k, v in fold(
            {"index": jnp.asarray(index), "term": jnp.int32(1)},
            jnp.asarray(cmd), jnp.asarray(mask),
            jax.tree.map(jnp.asarray, st)).items()}
        for n, p in np.ndindex(N, P):
            got = _composed_fold(Q, G, cmd[n, p], mask[n, p],
                                 {k: v[n, p] for k, v in st.items()})
            for k, v in got.items():
                assert np.array_equal(np.asarray(v, np.int64),
                                      want[k][n, p]), (w, n, p, k)
        st = want


def test_fold_choice_on_card_follows_capacity():
    """Where the two folds of a clean window differ: a ring of 5 whose
    tail is 2**31 - 1 takes two appends.  The in-order fold writes slot 2
    twice (``floor_mod(2**31 - 1, 5)`` and ``floor_mod(-2**31, 5)`` are
    both 2), the fast fold writes slots 2 and 3, and the reference's batch
    fold keeps the fast one.  So a capacity that is no power of two sets
    ``fast_fold_on_card`` (the card then keeps the reference's choice
    too), and a power of two, where the folds agree, does not."""
    ref_m, port_m = RefStream(5, 2), StreamMachine(5, 2)
    st = {"buf": np.zeros((1, 5), np.int32),
          "tail": np.full(1, 2 ** 31 - 1, np.int32),
          "base": np.full(1, 2 ** 31 - 6, np.int32),
          "cursors": np.zeros((1, 2), np.int32)}
    cmd = np.array([[[1, 11, 0], [1, 22, 0]]], np.int32)
    mask = np.ones((1, 2), bool)
    index = np.array([[1, 2]], np.int32)
    rmeta = {"index": jnp.asarray(index), "term": jnp.int32(1)}
    pmeta = {"index": torch.from_numpy(index),
             "term": torch.tensor(1, dtype=torch.int32)}
    rargs = (jnp.asarray(cmd), jnp.asarray(mask),
             jax.tree.map(jnp.asarray, st))
    pargs = (torch.from_numpy(cmd), torch.from_numpy(mask), to_port(st))
    fast = port_m._batch_fast(*pargs)
    in_order = port_m.sequential_window_fold(pmeta, *pargs)
    assert fast["buf"].tolist() == [[0, 0, 11, 22, 0]]
    assert in_order["buf"].tolist() == [[0, 0, 22, 0, 0]]
    assert_tree_equal(port_m.jit_apply_batch(pmeta, *pargs),
                      jax.jit(ref_m.jit_apply_batch)(rmeta, *rargs),
                      "batch fold at the int32 edge")
    assert_tree_equal(fast, ref_m._batch_fast(*rargs), "fast fold")
    assert [StreamMachine(q).fast_fold_on_card for q in (5, 12, 64, 8, 1)] \
        == [True, True, False, False, False]


HOST_COMMANDS = [("append", 5), ("append", -1), ("append", 2 ** 31),
                 ("append", "7"), ("append",), ("commit", 1, 9),
                 ("commit", -1, 3), ("commit", 1), ("truncate", 4),
                 ("truncate", 2 ** 40), ("put", 1, 2), (), None, "append",
                 ["append", 1]]
HOST_QUERIES = [("read", 3), ("read", -1), ("read", 2 ** 40),
                ("cursor", 2), ("cursor", "x"), ("bounds",), (), None]


def _encoded(fn, x):
    try:
        return np.asarray(fn(x))
    except Exception as e:  # noqa: BLE001 -- both packages must agree
        return type(e).__name__


def test_encoders_decoders_and_bounds_match_reference():
    ref_m, port_m = RefStream(), StreamMachine()
    for ref_fn, port_fn, items in (
            (ref_m.encode_command, port_m.encode_command, HOST_COMMANDS),
            (ref_m.encode_query, port_m.encode_query, HOST_QUERIES)):
        for x in items:
            want, got = _encoded(ref_fn, x), _encoded(port_fn, x)
            if isinstance(want, str):
                assert got == want, (x, got, want)
            else:
                assert got.dtype == want.dtype and \
                    np.array_equal(got, want), x
    for reply in ([1, 4], [-2, -1], [0, 0]):
        r = np.asarray(reply, np.int32)
        assert port_m.decode_reply(torch.from_numpy(r)) == \
            ref_m.decode_reply(jnp.asarray(r))
        assert port_m.decode_query_reply(torch.from_numpy(r)) == \
            ref_m.decode_query_reply(jnp.asarray(r))
    st = {"buf": np.zeros(4, np.int32), "tail": np.int32(9),
          "base": np.int32(5), "cursors": np.zeros(2, np.int32)}
    assert query_bounds(to_port(st)) == ref_query_bounds(
        jax.tree.map(jnp.asarray, st)) == (5, 9)


# -- the engine -----------------------------------------------------------

def _pay(rng, n, kc, tail_hint):
    """[n, kc, 3] stream commands for the engine: appends, commits near
    the tail, truncates and invalid ops."""
    op = rng.choice([0, 1, 1, 1, 1, 2, 2, 3, 4], (n, kc))
    a = np.where(op == 2, rng.integers(-1, 5, (n, kc)),
                 rng.integers(-2, tail_hint + 8, (n, kc)))
    b = rng.integers(-3, tail_hint + 8, (n, kc))
    return np.stack([op, a, b], -1).astype(np.int32)


def test_engine_matches_reference_with_reads():
    """16 lanes x 5 members, StreamMachine(8, 4) (a ring shorter than a
    step's window, so retention moves every step): failures, recovery,
    membership changes, elections and read batches; every LaneState leaf
    and aux key equal after every step."""
    n, p, kc = 16, 5, 6
    kw = dict(write_delay=1, max_step_cmds=kc, ring_capacity=16,
              apply_window=8, max_step_reads=3, lease_ttl=3,
              read_timeout=6)
    ref = ref_lockstep.LockstepEngine(RefStream(8, 4), n, p, **kw)
    port = port_lockstep.LockstepEngine(StreamMachine(8, 4), n, p,
                                        device="cpu", **kw)
    rng = np.random.default_rng(5)
    failed = {}
    for i in range(30):
        host_verbs(rng, ref, port, failed, i)
        n_new = rng.integers(0, kc + 1, n).astype(np.int32)
        pay = _pay(rng, n, kc, 4 * i)
        step_kw = {}
        if rng.random() < 0.3:
            step_kw["elect_mask"] = rng.random(n) < 0.2
        if rng.random() < 0.6:
            step_kw["n_read"] = rng.integers(0, 4, n).astype(np.int32)
            step_kw["read_q"] = np.stack(
                [rng.integers(0, 3, (n, 3)),
                 rng.integers(-2, 4 * i + 8, (n, 3))], -1).astype(np.int32)
        assert_same(ref, port, ref.step(n_new, pay, **step_kw),
                    port.step(n_new, pay, **step_kw), what=f"step {i}")
    st = port.state
    assert int(st.total_committed.sum()) > 0
    assert int(st.read_served.sum()) > 0
    assert int(st.telem.leader_changes.sum()) > 0


def test_checkpoints_round_trip_both_ways(tmp_path):
    """The stream's state tree through the converter: a reference archive
    restores into the port and a port archive into the reference (the
    ``<field>:<leaf>`` keys, the dict leaves in sorted order), and the
    reference's positional archive (``a<i>``) into both; every leaf
    equal, and both step on alike."""
    kw = dict(ring_capacity=32, max_step_cmds=4, max_step_reads=2)
    ref = ref_lockstep.LockstepEngine(RefStream(8, 3), 8, 3, **kw)
    port = port_lockstep.LockstepEngine(StreamMachine(8, 3), 8, 3,
                                        device="cpu", **kw)
    rng = np.random.default_rng(4)
    for i in range(6):
        n_new = rng.integers(0, 5, 8).astype(np.int32)
        pay = _pay(rng, 8, 4, 3 * i)
        assert_same(ref, port, ref.step(n_new, pay), port.step(n_new, pay))
    ref.save(str(tmp_path / "ref.npz"))
    port.save(str(tmp_path / "port.npz"))
    fresh_port = port_lockstep.LockstepEngine(StreamMachine(8, 3), 8, 3,
                                              device="cpu", **kw)
    fresh_port.restore(str(tmp_path / "ref.npz"))
    assert_same(ref, fresh_port, what="reference -> port")
    fresh_ref = ref_lockstep.LockstepEngine(RefStream(8, 3), 8, 3, **kw)
    fresh_ref.restore(str(tmp_path / "port.npz"))
    assert_same(fresh_ref, port, what="port -> reference")
    path = positional_archives(ref.state, tmp_path)["full"]
    pos = port_lockstep.LockstepEngine(StreamMachine(8, 3), 8, 3,
                                       device="cpu", **kw)
    pos.restore(path)
    assert_same(ref, pos, what="positional -> port")
    pay = _pay(rng, 8, 4, 30)
    n_new = np.full(8, 4, np.int32)
    for e in (fresh_ref, fresh_port, pos):
        e.step(n_new, pay)
    assert_same(fresh_ref, fresh_port, what="after a step")
    assert_same(fresh_ref, pos, what="positional after a step")


# -- twins of the reference's stream read-plane cases ----------------------

RN, RP, RK = 8, 3, 4     # the reference read tests' lanes, members, cmds


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Pair:
    """The reference engine and the port's, driven as one: every verb goes
    to both, states are compared after each, and a read returns the
    port's answer once it equals the reference's."""

    def __init__(self, machine_args, **kw):
        self.ref = ref_lockstep.LockstepEngine(RefStream(*machine_args),
                                               RN, RP, **kw)
        self.port = port_lockstep.LockstepEngine(
            StreamMachine(*machine_args), RN, RP, device="cpu", **kw)
        self.lease_ttl = self.port.lease_ttl

    @property
    def state(self):
        return self.port.state

    def check(self, what):
        assert_same(self.ref, self.port, what=what)

    def step(self, n_new, pay):
        for e in (self.ref, self.port):
            e.step(n_new, pay)

    def zeros_step(self):
        self.step(np.zeros((RN,), np.int32),
                  np.zeros((RN, self.port.max_step_cmds, 3), np.int32))

    def verb(self, name, *args):
        for e in (self.ref, self.port):
            getattr(e, name)(*args)

    def read_lanes(self, lanes, queries):
        want = self.ref.read_lanes(lanes, queries)
        got = self.port.read_lanes(lanes, queries)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype and \
                np.array_equal(g, np.asarray(w)), (got, want)
        self.check("after read_lanes")
        return got


def _drain(pair, limit=64):
    lane = np.arange(RN)
    for _ in range(limit):
        st = pair.state
        leads = _np(st.leader_slot)
        tail = _np(st.last_index)[lane, leads]
        com = _np(st.commit)[lane, leads]
        act = _np(st.active)
        app = np.where(act, _np(st.applied),
                       np.iinfo(np.int32).max).min(axis=1)
        if (com >= tail).all() and (app >= com).all():
            return
        pair.zeros_step()
    raise AssertionError("read-plane drain did not converge")


class StreamModel:
    """The reference test's fold of the committed stream history."""

    def __init__(self, capacity=16, groups=4):
        self.q, self.g = capacity, groups
        self.buf: dict = {}
        self.tail = self.base = 0
        self.cursors = [0] * groups

    def apply(self, cmd) -> None:
        op, a, b = (int(x) for x in cmd)
        if op == 1 and a >= 0:
            self.buf[self.tail] = a
            self.tail += 1
        elif op == 2 and 0 <= a < self.g:
            self.cursors[a] = min(max(self.cursors[a], b, 0), self.tail)
        elif op == 3:
            self.base = min(max(self.base, a, 0), self.tail)
        self.base = max(self.base, self.tail - self.q)

    def query(self, q) -> tuple:
        op, a = int(q[0]), int(q[1])
        if op == 0:
            return (self.tail, self.base)
        if op == 1:
            return (1, self.buf[a]) if self.base <= a < self.tail \
                else (0, -1)
        return (1, self.cursors[a]) if 0 <= a < self.g else (0, -1)


def test_read_lanes_round_trip_stream():
    """The stream case of the reference's
    ``test_read_lanes_round_trip_query_machines``: two appends, then a
    read of offset 1 serves 43 on every lane, in both packages."""
    pair = Pair((8, 2), ring_capacity=32, max_step_cmds=4,
                max_step_reads=4, lease_ttl=4)
    pay = np.zeros((RN, 4, 3), np.int32)
    pay[:, 0] = (1, 42, 0)
    pay[:, 1] = (1, 43, 0)
    pair.step(np.full((RN,), 2, np.int32), pay)
    _drain(pair)
    replies, wm, ok = pair.read_lanes(
        np.arange(RN), np.tile(np.asarray([[1, 1]], np.int32), (RN, 1)))
    assert ok.all() and (wm >= 0).all()
    assert (replies[:, 0] == 1).all() and (replies[:, 1] == 43).all()


def test_read_oracle_stream():
    """The reference's ``test_read_oracle_stream`` (seed 1, 12 rounds) on
    both engines at once: traffic, quorum-preserving member kills, a
    majority partition whose leader must refuse past its lease, healing
    and elections; every served read equals the model over the whole
    committed history (no stale serve), the two engines agree on every
    reply, watermark and leaf, and the healed lanes all serve."""
    rng = random.Random(1)
    pair = Pair((16, 4), ring_capacity=64, max_step_cmds=RK,
                max_step_reads=4, lease_ttl=4)
    snaps = [StreamModel(16, 4)]
    down: dict = {lane: set() for lane in range(RN)}
    last_wm = np.full((RN,), -1, np.int32)
    stats = {"served": 0, "refused": 0}

    def query(tail):
        r = rng.random()
        if r < 0.3:
            return (0, 0)
        if r < 0.8:
            return (1, rng.randrange(-1, tail + 2))
        return (2, rng.randrange(-1, 5))

    def submit(cmds):
        pay = np.zeros((RN, RK, 3), np.int32)
        for k, c in enumerate(cmds):
            pay[:, k] = c
        pair.step(np.full((RN,), RK, np.int32), pay)
        _drain(pair)
        for c in cmds:
            m = copy.deepcopy(snaps[-1])
            m.apply(c)
            snaps.append(m)

    def read_wave(must_refuse=None):
        qs = [query(snaps[-1].tail) for _ in range(RN)]
        replies, wm, ok = pair.read_lanes(np.arange(RN),
                                          np.asarray(qs, np.int32))
        if must_refuse is not None:
            assert not ok[must_refuse]
        for lane in range(RN):
            if not ok[lane]:
                stats["refused"] += 1
                continue
            stats["served"] += 1
            got = (int(replies[lane][0]), int(replies[lane][1]))
            assert got == snaps[-1].query(qs[lane]), (lane, qs[lane], got)
            assert wm[lane] >= last_wm[lane]
            last_wm[lane] = wm[lane]

    for r in range(12):
        roll = rng.random()
        if roll < 0.45:
            tail = snaps[-1].tail
            cmds = []
            for _ in range(RK):
                x = rng.random()
                if x < 0.7:
                    cmds.append((1, rng.randrange(1, 100), 0))
                elif x < 0.9:
                    cmds.append((2, rng.randrange(4),
                                 rng.randrange(tail + 2)))
                else:
                    cmds.append((3, rng.randrange(tail + 2), 0))
            submit(cmds)
        elif roll < 0.6:
            leads = _np(pair.state.leader_slot)
            for lane in range(RN):
                if len(down[lane]) >= (RP - 1) // 2:
                    continue
                victim = rng.choice([s for s in range(RP)
                                     if s not in down[lane]])
                pair.verb("fail_member", lane, victim)
                down[lane].add(victim)
                if victim == int(leads[lane]):
                    pair.verb("trigger_election", [lane])
        elif roll < 0.75:
            lane = rng.randrange(RN)
            lead = int(_np(pair.state.leader_slot)[lane])
            cut = [s for s in range(RP) if s != lead and s not in down[lane]]
            for s in cut:
                pair.verb("fail_member", lane, s)
            for _ in range(3 * pair.lease_ttl):
                pair.zeros_step()
            read_wave(must_refuse=lane)
            for s in cut:
                pair.verb("recover_member", lane, s)
            st = pair.state
            if not _np(st.active)[lane, int(_np(st.leader_slot)[lane])]:
                pair.verb("trigger_election", [lane])
            _drain(pair, limit=96)
            pair.check(f"round {r}")
            continue
        elif roll < 0.9:
            leads = _np(pair.state.leader_slot)
            for lane in range(RN):
                if down[lane]:
                    slot = rng.choice(sorted(down[lane]))
                    if slot != int(leads[lane]):
                        pair.verb("recover_member", lane, slot)
                        down[lane].discard(slot)
            _drain(pair, limit=96)
        else:
            healthy = [lane for lane in range(RN) if not down[lane]]
            if healthy:
                pair.verb("trigger_election", healthy)
        pair.check(f"round {r}")
        read_wave()
    for _ in range(3):
        leads = _np(pair.state.leader_slot)
        for lane in range(RN):
            for slot in sorted(down[lane]):
                if slot != int(leads[lane]):
                    pair.verb("recover_member", lane, slot)
                    down[lane].discard(slot)
        broken = [lane for lane in range(RN) if down[lane]]
        if broken:
            pair.verb("trigger_election", broken)
    assert not any(down.values()), down
    _drain(pair, limit=128)
    qs = [query(snaps[-1].tail) for _ in range(RN)]
    replies, _wm, ok = pair.read_lanes(np.arange(RN),
                                       np.asarray(qs, np.int32))
    assert ok.all()
    for lane in range(RN):
        assert (int(replies[lane][0]), int(replies[lane][1])) == \
            snaps[-1].query(qs[lane])
    assert stats["served"] > 0


# -- the stream decoder on the card ----------------------------------------

#: (Q, G, n, p, a, share applied): lane counts no multiple of a block's,
#: A = 1 and > Q, all-masked and one-command windows, 9 and 40 groups
DECODER_CASES = [(Q, G, n, p, a, 0.85) for Q, G in SHAPES
                 for n, p, a in [(6, 3, 9), (129, 1, 1), (300, 7, 20),
                                 (33, 16, 140)]] + [
    (30_000, 40, 33, 3, 40, 0.85), (64, 4, 1_003, 5, 130, 0.85),
    (64, 4, 1_001, 1, 70, 0.85), (5, 2, 1_003, 5, 130, 0.85),
    (64, 4, 257, 16, 150, 0.85), (64, 4, 999, 5, 130, 0.0),
    (5, 2, 77, 5, 1, 1.0), (64, 9, 301, 5, 70, 0.85)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,n,p,a,keep", DECODER_CASES)
def test_stream_decoder_matches_plain_on_card(cuda_device, Q, G, n, p, a,
                                              keep):
    """``StreamMachine.in_order_fold`` on the card (one launch of the
    stream decoder) against the plain version on the same inputs: random,
    append-only and int32-edge windows, chained; every leaf equal.  Forty
    groups (and a ring of 30,000) take the one-thread kernel, folding in
    device memory."""
    m = StreamMachine(Q, G)
    rng = np.random.default_rng(Q + n + p + a)
    st = to_port(stream_state(rng, (n, p), Q, G))
    st = {k: v.to(cuda_device) for k, v in st.items()}
    for w in range(3):
        cmd = torch.from_numpy(stream_cmds(rng, (n, a), G, clean=w == 1))
        cmds = cmd.to(cuda_device)[:, None].expand(n, p, a, 3)
        mask = torch.from_numpy(rng.random((n, p, a)) < keep).to(
            cuda_device)
        meta = {"index": torch.ones((n, p, a), dtype=torch.int32,
                                    device=cuda_device),
                "term": torch.ones((), dtype=torch.int32,
                                   device=cuda_device)}
        want = m.sequential_window_fold(meta, cmds, mask, st)
        before = slot_fold.LAUNCHES
        got = m.in_order_fold(meta, cmds, mask, st)
        torch.cuda.synchronize()
        assert slot_fold.LAUNCHES == before + 1
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                torch.equal(got[k], want[k]), (k, w)
        st = got


@pytest.mark.cuda
def test_stream_q5_batch_fold_on_card_matches_reference(cuda_device):
    """A ring of 5 (no power of two), tails and bases at the int32 edge
    (``chip_smoke.stream_state``), clean windows (noops and appends,
    where the reference keeps the fast fold) between mixed ones (the
    stream decoder): the card's batch fold keeps the reference's choice,
    and every leaf equals the reference's, window after window."""
    ref_m, port_m = RefStream(5, 2), StreamMachine(5, 2)
    assert port_m.fast_fold_on_card
    batch = jax.jit(ref_m.jit_apply_batch)
    n, p, a = 129, 3, 40
    rng = np.random.default_rng(5)
    rs = stream_state(rng, (n, p), 5, 2)
    for w in range(4):
        cmd = np.ascontiguousarray(np.broadcast_to(
            stream_cmds(rng, (n, 1, a), 2, clean=w % 2 == 0), (n, p, a, 3)))
        mask = rng.random((n, p, a)) < 0.9
        index = np.ones((n, p, a), np.int32)
        want = batch({"index": jnp.asarray(index), "term": jnp.int32(1)},
                     jnp.asarray(cmd), jnp.asarray(mask),
                     jax.tree.map(jnp.asarray, rs))
        before = slot_fold.LAUNCHES
        got = port_m.jit_apply_batch(
            {"index": torch.from_numpy(index).to(cuda_device),
             "term": torch.ones((), dtype=torch.int32, device=cuda_device)},
            torch.from_numpy(cmd).to(cuda_device),
            torch.from_numpy(mask).to(cuda_device),
            {k: torch.from_numpy(v).to(cuda_device) for k, v in rs.items()})
        assert slot_fold.LAUNCHES == before + 1
        assert_tree_equal({k: v.cpu() for k, v in got.items()}, want,
                          f"window {w}")
        rs = {k: np.array(v) for k, v in want.items()}
