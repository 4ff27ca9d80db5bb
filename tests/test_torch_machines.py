"""The port's order-dependent machines (registers, KV, TTL-KV, FIFO under
both overflow policies) against the JAX reference: the same numpy-seeded
inputs go through both packages, and every state leaf, reply, query reply
and encoded command must be equal, dtypes included (``np.array_equal``).
Batched machine state has leading dims [N, P], as the engine holds it.

Also the exact one-hot selection (``ops/exact.py``) against the
reference's 16-bit-half matmul, and, on a card only (``cuda`` marker), the
two fold kernels (``ops/csrc/slot_fold.cu``, ``ops/csrc/fifo_fold.cu``)
against their plain version, the machine's ``sequential_window_fold``.

The FIFO's hard windows (full ready windows, several rows requeued at
once, heads and tickets at the int32 edges, duplicate tickets) come from
``chip_smoke.py``'s generator, so the CPU and the card hold the same
cases."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.models import jit_fifo as ref_jit_fifo
from ra_tpu.models.jit_fifo import JitFifoMachine as RefFifo
from ra_tpu.models.jit_kv import JitKvMachine as RefKv
from ra_tpu.models.registers import RegisterMachine as RefRegisters
from ra_tpu.models.ttl_kv import TtlKvMachine as RefTtlKv
from ra_tpu.ops import exact as ref_exact
from ra_tpu_torch.core.tree import tree_leaves
from ra_tpu_torch.models import JitFifoMachine, JitKvMachine, \
    RegisterMachine, TtlKvMachine
from ra_tpu_torch.models import jit_fifo
from ra_tpu_torch.ops import exact, fifo_fold, slot_fold

from chip_smoke import fold_operands
from test_torch_classic_card import cuda_device  # noqa: F401

N, P = 6, 3
CPU = torch.device("cpu")


def _registers_cmds(rng, shape, clean):
    op = rng.integers(0, 3 if clean else 5, shape)          # 4: unknown
    slot = rng.integers(-2, 10, shape)                      # clipped
    value = rng.integers(-3, 4, shape)
    big = rng.random(shape) < 0.1                           # int32 wrap
    value = np.where(big, rng.choice([2 ** 31 - 1, -2 ** 31], shape), value)
    return np.stack([op, slot, value, rng.integers(-3, 4, shape)], -1)


def _kv_cmds(rng, shape, clean):
    op = rng.integers(0, 4 if clean else 6, shape)          # 5: unknown
    return np.stack([op, rng.integers(-2, 18, shape),       # bad keys
                     rng.integers(-3, 8, shape),            # bad values
                     rng.integers(-2, 5, shape)], -1)


def _ttl_cmds(rng, shape, clean):
    op = rng.integers(0, 6, shape)
    ttl = np.where(rng.random(shape) < 0.1, 2 ** 31 - 1,    # clock wraps
                   rng.integers(-2, 6, shape))
    return np.stack([op, rng.integers(-2, 18, shape),
                     rng.integers(-3, 8, shape), ttl], -1)


def _fifo_cmds(rng, shape, clean):
    op = rng.integers(0, 3 if clean else 13, shape)         # 12: unknown
    return np.stack([op, rng.integers(0, 6, shape),
                     rng.integers(0, 4, shape)], -1)


#: name -> (reference machine, port machine, command generator)
MACHINES = {
    "registers": (lambda: RefRegisters(8), lambda: RegisterMachine(8),
                  _registers_cmds),
    "kv": (lambda: RefKv(16), lambda: JitKvMachine(16), _kv_cmds),
    "ttl_kv": (lambda: RefTtlKv(16), lambda: TtlKvMachine(16), _ttl_cmds),
    "fifo_reject": (lambda: RefFifo(8, 4, 2), lambda: JitFifoMachine(8, 4, 2),
                    _fifo_cmds),
    "fifo_drop_head": (lambda: RefFifo(8, 4, 2, overflow="drop_head"),
                       lambda: JitFifoMachine(8, 4, 2, overflow="drop_head"),
                       _fifo_cmds),
    # a capacity that is no power of two; K and C that are none either
    "fifo_odd": (lambda: RefFifo(12, 5, 3, overflow="drop_head"),
                 lambda: JitFifoMachine(12, 5, 3, overflow="drop_head"),
                 _fifo_cmds),
}


def to_port(tree):
    """A reference (JAX or numpy) tree as the port's torch tree."""
    return jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)), tree)


def assert_tree_equal(got, want, what):
    gl = [x.numpy() for x in tree_leaves(got)]
    wl = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), what
    for j, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype, (what, j, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, j, g.shape, w.shape)
        assert np.array_equal(g, w), (what, j)


@functools.lru_cache(maxsize=None)
def ref_machine(name):
    """The reference machine and its jitted ``jit_apply_batch`` (one
    compile a window shape, shared by the tests)."""
    m = MACHINES[name][0]()
    return m, jax.jit(m.jit_apply_batch)


def evolved(name, steps, seed):
    """Both machines' [N, P] states after ``steps`` random commands (the
    reference's and the port's, checked equal on the way), and the rng."""
    ref_m, _batch = ref_machine(name)
    apply = ref_m.jit_apply
    port_m, gen = MACHINES[name][1](), MACHINES[name][2]
    rng = np.random.default_rng(seed)
    rs = jax.tree.map(lambda x: jnp.broadcast_to(
        x[:, None], (N, P) + x.shape[1:]), ref_m.jit_init(N))
    ps = to_port(rs)
    for i in range(steps):
        cmd = gen(rng, (N, P), clean=False).astype(np.int32)
        index = rng.integers(i, i + 3, (N, P)).astype(np.int32)
        rs, rr = apply({"index": jnp.asarray(index), "term": jnp.int32(1)},
                       jnp.asarray(cmd), rs)
        ps, pr = port_m.jit_apply(
            {"index": torch.from_numpy(index), "term": torch.tensor(1)},
            torch.from_numpy(cmd), ps)
        assert_tree_equal(ps, rs, f"{name} jit_apply state, command {i}")
        assert_tree_equal(pr, rr, f"{name} jit_apply reply, command {i}")
    return ref_m, port_m, rs, ps, rng


# -- exact selection ----------------------------------------------------------

@pytest.mark.parametrize("shape,hot", [((4, 5, 7), "bool"),
                                       ((3, 2, 6, 9), "float"),
                                       ((8, 1), "bool")])
def test_exact_selection_matches_reference(shape, hot):
    rng = np.random.default_rng(len(shape))
    *lead, a, r = shape
    col = rng.integers(0, r, lead + [a])
    oh = (np.arange(r) == col[..., None]) & (rng.random(lead + [a, 1]) < 0.7)
    vals = rng.integers(-2 ** 31, 2 ** 31, lead + [r, 3], dtype=np.int64)
    vals = vals.astype(np.int32)
    oh_ref = oh.astype(np.float32)
    oh_port = torch.from_numpy(oh) if hot == "bool" else \
        torch.from_numpy(oh_ref)
    want = ref_exact.split16_matmul(jnp.asarray(oh_ref), jnp.asarray(vals))
    got = exact.split16_matmul(oh_port, torch.from_numpy(vals))
    assert_tree_equal(got, want, "split16_matmul")
    want = ref_exact.place16(jnp.asarray(oh_ref), jnp.asarray(vals[..., 0]))
    got = exact.place16(oh_port, torch.from_numpy(vals[..., 0]))
    assert_tree_equal(got, want, "place16")


# -- init, apply, folds, queries ----------------------------------------------

@pytest.mark.parametrize("name", sorted(MACHINES))
def test_init_and_apply_match_reference(name):
    ref_m, port_m, _rs, _ps, _rng = evolved(name, steps=40, seed=1)
    assert_tree_equal(port_m.jit_init(N, CPU), ref_m.jit_init(N), "init")
    assert port_m.supports_batch_apply and ref_m.supports_batch_apply


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_window_folds_match_reference(name):
    """From an evolved state: the fast fold on clean windows, and the
    batch apply and the in-order fold on clean and mixed windows, chained
    window after window; for the FIFO also windows wider than the queue.
    Each is held against the reference's ``jit_apply_batch``, which its
    own tests hold equal to its in-order fold on every window."""
    ref_m, port_m, rs, ps, rng = evolved(name, steps=16, seed=2)
    ref_batch = ref_machine(name)[1]
    gen = MACHINES[name][2]
    widths = (5, 12, 40) if name.startswith("fifo") else (5, 9, 40)
    for w, A in enumerate(widths):
        for kind in ("clean", "mixed"):
            cmd = gen(rng, (N, A), clean=kind == "clean").astype(np.int32)
            # the engine's window: one command row a lane, read by every
            # member through a stride-0 member axis
            cmds = np.broadcast_to(cmd[:, None], (N, P) + cmd.shape[1:])
            mask = rng.random((N, P, A)) < 0.8
            mask[0] = True
            mask[1, 0] = False
            index = np.broadcast_to(
                (np.arange(A) + 40 + 10 * w).astype(np.int32), (N, P, A))
            rmeta = {"index": jnp.asarray(index),
                     "term": jnp.full((N, 1, 1), 1, jnp.int32)}
            pmeta = {"index": torch.from_numpy(index.copy()),
                     "term": torch.ones((N, 1, 1), dtype=torch.int32)}
            r_args = (jnp.asarray(cmds), jnp.asarray(mask), rs)
            p_args = (torch.from_numpy(cmd)[:, None].expand(cmds.shape),
                      torch.from_numpy(mask), ps)
            what = f"{name} A={A} {kind}"
            want = ref_batch(rmeta, *r_args)
            if kind == "clean" and hasattr(ref_m, "_batch_fast"):
                assert_tree_equal(port_m._batch_fast(*p_args), want,
                                  what + " _batch_fast")
            assert_tree_equal(port_m.sequential_window_fold(pmeta, *p_args),
                              want, what + " sequential_window_fold")
            got = port_m.jit_apply_batch(pmeta, *p_args)
            assert_tree_equal(got, want, what + " jit_apply_batch")
            rs, ps = want, got


@pytest.mark.parametrize("overflow", ["reject", "drop_head"])
def test_fifo_batch_apply_window_wider_than_queue(overflow):
    """A window wider than the queue aliases ring slots mod Q inside one
    window: each slot takes its last aliasing enqueue, exactly as the
    reference (and its sequential fold) does."""
    rng = np.random.default_rng(3)
    Q, A = 4, 9
    ref_m = RefFifo(capacity=Q, checkout_slots=2, overflow=overflow)
    port_m = JitFifoMachine(capacity=Q, checkout_slots=2, overflow=overflow)
    cmds = np.zeros((N, A, 3), np.int32)
    cmds[..., 0] = rng.integers(0, 3, (N, A))
    cmds[..., 1] = rng.integers(0, 6, (N, A))
    idx = np.broadcast_to(np.arange(A, dtype=np.int32), (N, A))
    want = ref_m.jit_apply_batch(
        {"index": jnp.asarray(idx), "term": jnp.int32(1)},
        jnp.asarray(cmds), jnp.ones((N, A), bool), ref_m.jit_init(N))
    got = port_m.jit_apply_batch(
        {"index": torch.from_numpy(idx.copy()), "term": torch.tensor(1)},
        torch.from_numpy(cmds), torch.ones((N, A), dtype=torch.bool),
        port_m.jit_init(N, CPU))
    assert_tree_equal(got, want, f"wider than the queue, {overflow}")


def hard_fifo_operands(m, rng, n, p, a, state=None, clean=False):
    """(meta, commands, mask, state) of one of ``chip_smoke.py``'s hard
    FIFO windows on the CPU (a ``fifo_hard_state`` start when ``state`` is
    None), its ops redrawn from 0-2 where ``clean``."""
    meta, cmds, mask, state = fold_operands(m, "fifo", n, p, a, rng, CPU,
                                            state, hard=True)
    if clean:
        cmd = cmds[:, 0].clone()
        cmd[..., 0] = torch.from_numpy(rng.integers(0, 3, (n, a)))
        cmds = cmd[:, None].expand(cmds.shape)
    return meta, cmds, mask, state


def ref_fold_by_row(ref_m, meta, cmds, mask, state):
    """The reference's ``sequential_window_fold`` of each replica row
    alone ([1, 1] leading dims), as numpy [n, p, ...]."""
    fold = jax.jit(ref_m.sequential_window_fold)
    n, p = mask.shape[:2]
    out = {k: np.empty(v.shape, np.int32) for k, v in state.items()}
    for i in range(n):
        for j in range(p):
            got = fold({"index": jnp.asarray(meta["index"][i:i + 1, j:j + 1]),
                        "term": jnp.asarray(meta["term"][i:i + 1])},
                       jnp.asarray(cmds[i:i + 1, j:j + 1]),
                       jnp.asarray(mask[i:i + 1, j:j + 1]),
                       {k: jnp.asarray(v[i:i + 1, j:j + 1])
                        for k, v in state.items()})
            for k, v in got.items():
                out[k][i, j] = np.asarray(v)[0, 0]
    return out


@pytest.mark.parametrize("q,k,c,overflow", [(8, 4, 2, "reject"),
                                            (12, 5, 3, "drop_head"),
                                            (40, 13, 9, "reject"),
                                            (256, 8, 4, "drop_head")])
def test_fifo_hard_windows_match_reference(q, k, c, overflow):
    """The hard FIFO windows the kernel checks use (full ready windows,
    returns and cancels of several rows at once, heads and tickets at the
    int32 edges, duplicate tickets, ids that wrap), two chained: the
    port's in-order fold equals the reference's fold of each replica
    alone, and where Q is a power of two its fold of the whole batch; on
    clean windows the port's ``jit_apply_batch`` (the fast fold) equals
    the reference's."""
    ref_m = RefFifo(q, k, c, overflow=overflow)
    port_m = JitFifoMachine(q, k, c, overflow=overflow)
    rng = np.random.default_rng(q + k + c)
    n, p, a = 12, 3, 40
    state = None
    for w in range(2):
        meta, cmds, mask, state = hard_fifo_operands(port_m, rng, n, p, a,
                                                     state)
        got = port_m.sequential_window_fold(meta, cmds, mask, state)
        want = ref_fold_by_row(ref_m, meta, cmds, mask, state)
        assert_tree_equal(got, want, f"window {w}, by row")
        if q & (q - 1) == 0:
            batch = jax.jit(ref_m.sequential_window_fold)(
                {"index": jnp.asarray(meta["index"]),
                 "term": jnp.asarray(meta["term"])}, jnp.asarray(cmds),
                jnp.asarray(mask), {k_: jnp.asarray(v)
                                    for k_, v in state.items()})
            assert_tree_equal(got, batch, f"window {w}, batch")
        state = got
    meta, cmds, mask, _ = hard_fifo_operands(port_m, rng, n, p, a, state,
                                             clean=True)
    want = jax.jit(ref_m.jit_apply_batch)(
        {"index": jnp.asarray(meta["index"]),
         "term": jnp.asarray(meta["term"])}, jnp.asarray(cmds),
        jnp.asarray(mask), {k_: jnp.asarray(v) for k_, v in state.items()})
    assert_tree_equal(port_m.jit_apply_batch(meta, cmds, mask, state), want,
                      "clean window, fast fold")


def test_fifo_bystander_row_keeps_its_ring_at_the_int32_edge():
    """The one place the port's fold departs from the reference's batch
    fold, pinned: with Q not a power of two and a row's head at the int32
    edge, the reference's merge (behind one lax.cond over the batch)
    moves that row's ready entries when ANOTHER row of the batch
    requeues, though the row itself requeues nothing.  The port merges
    only the rows that requeue, as the reference does for a row folded
    alone, so replicas that apply a command in different batches stay
    equal."""
    Q, K, C = 12, 2, 1
    ref_m, port_m = RefFifo(Q, K, C), JitFifoMachine(Q, K, C)
    st = {k: np.array(v)[:2].copy() for k, v in ref_m.jit_init(2).items()}
    st["buf"][:] = np.arange(Q)
    st["mid"][:] = np.arange(Q)
    st["head"][:] = [0, -2 ** 31]                # row 1 at the edge
    st["tail"][:] = [4, -2 ** 31 + 4]
    st["co_id"][0, 0], st["co_mid"][0, 0] = 7, 1  # row 0 holds id 7
    cmd = np.array([[5, 7, 0], [0, 0, 0]], np.int32)   # row 0 returns it
    meta_r = {"index": jnp.zeros(2, jnp.int32), "term": jnp.int32(1)}
    ref_batch, _ = ref_m.jit_apply(meta_r, jnp.asarray(cmd),
                                   {k: jnp.asarray(v) for k, v in st.items()})
    got, _ = port_m.jit_apply(
        {"index": torch.zeros(2, dtype=torch.int32), "term": torch.tensor(1)},
        torch.from_numpy(cmd), {k: torch.from_numpy(v) for k, v in st.items()})
    # row 1 alone: its noop leaves it as it was, in both packages
    assert np.array_equal(got["buf"][1].numpy(), st["buf"][1])
    assert not np.array_equal(np.asarray(ref_batch["buf"])[1], st["buf"][1])
    # row 0, which requeues, is merged alike
    assert_tree_equal({k: v[0] for k, v in got.items()},
                      {k: np.asarray(v)[0] for k, v in ref_batch.items()},
                      "the requeueing row")


#: the reference's scripted FIFO sequences (test_jit_fifo.py): consumer
#: credit, cancel and down; a return and a cancel interleaving by ticket;
#: drop_head with and without a ready message to drop
FIFO_SCRIPTS = {
    "consumers": (dict(capacity=8, checkout_slots=4, consumer_slots=2), [
        [1, 10], [1, 11], [1, 12], [1, 13], [10, 7, 0], [7, 7, 2],
        [7, 9, 1], [7, 8, 1], [10, 7, 0], [10, 7, 0], [10, 7, 0],
        [10, 9, 0], [10, 9, 0], [11, 9, 2], [10, 9, 0], [4, 0, 0],
        [10, 7, 0], [8, 7, 0], [10, 7, 0], [7, 7, 1], [9, 9, 0],
        [9, 99, 0], [6], [2], [3]]),
    "interleaved_return_and_cancel": (
        dict(capacity=8, checkout_slots=4, consumer_slots=2), [
            [1, 20], [1, 21], [1, 22], [7, 5, 3], [10, 5, 0], [10, 5, 0],
            [3, 0, 0], [5, 1, 0], [8, 5, 0], [2], [2], [2]]),
    "drop_head": (dict(capacity=3, checkout_slots=2, overflow="drop_head"), [
        [1, 10], [1, 11], [1, 12], [1, 13], [1, 14], [3, 0, 0], [3, 0, 0],
        [2, 0, 0], [1, 15], [1, 16], [5, 4, 0], [1, 17], [1, 18]]),
    "drop_head_nothing_ready": (
        dict(capacity=2, checkout_slots=2, overflow="drop_head"),
        [[1, 10], [1, 11], [3, 0], [3, 0], [1, 12]]),
}


@pytest.mark.parametrize("script", sorted(FIFO_SCRIPTS))
def test_fifo_scripts_match_reference(script):
    """Lane-less state (leading dims []), one command at a time, as the
    reference's scripted tests drive it: every state leaf and reply."""
    cfg, cmds = FIFO_SCRIPTS[script]
    ref_m, port_m = RefFifo(**cfg), JitFifoMachine(**cfg)
    rs = {k: v[0] for k, v in ref_m.jit_init(1).items()}
    ps = {k: v[0] for k, v in port_m.jit_init(1, CPU).items()}
    apply = ref_m.jit_apply
    for i, c in enumerate(cmds):
        c = np.asarray((c + [0, 0])[:3], np.int32)
        rs, rr = apply({"index": jnp.int32(i), "term": jnp.int32(1)},
                       jnp.asarray(c), rs)
        ps, pr = port_m.jit_apply({"index": torch.tensor(i),
                                   "term": torch.tensor(1)},
                                  torch.from_numpy(c), ps)
        assert_tree_equal(ps, rs, f"{script} command {i} state")
        assert_tree_equal(pr, rr, f"{script} command {i} reply")
    for fn in ("query_depth", "query_checked_out", "query_consumers",
               "query_dropped"):
        assert int(getattr(jit_fifo, fn)(ps)) == \
            getattr(ref_jit_fifo, fn)(rs), fn


@pytest.mark.parametrize("name", ["kv", "ttl_kv"])
def test_queries_match_reference(name):
    ref_m, port_m, rs, ps, rng = evolved(name, steps=24, seed=4)
    # the engine queries the leader's replica: [N, ...] state
    rs = jax.tree.map(lambda x: x[:, 1], rs)
    ps = jax.tree.map(lambda x: x[:, 1], ps)
    q = np.stack([rng.integers(0, 4, (N, 5)),
                  rng.integers(-2, 18, (N, 5))], -1).astype(np.int32)
    assert_tree_equal(port_m.jit_query(torch.from_numpy(q), ps),
                      ref_m.jit_query(jnp.asarray(q), rs), "jit_query")


def test_ttl_query_live_matches_reference():
    """``query_live`` (the TTL-KV host query fun) on every lane's replica
    of an evolved state, expired and wrapped deadlines included."""
    from ra_tpu.models.ttl_kv import query_live as ref_query_live
    from ra_tpu_torch.models.ttl_kv import query_live
    _ref_m, _port_m, rs, ps, _rng = evolved("ttl_kv", steps=24, seed=6)
    seen = set()
    for lane in range(N):
        for member in range(ps["vals"].shape[1]):
            got = query_live({k: v[lane, member] for k, v in ps.items()})
            want = ref_query_live({k: v[lane, member]
                                   for k, v in rs.items()})
            assert got == want, (lane, member)
            seen.add(len(got))
    assert len(seen) > 1


HOST_COMMANDS = [
    ("put", 1, 5), ("put", 3, -1), ("put", 2, None), ("put", 1, 2, 7),
    ("put", 1, 2 ** 31 - 1), ("put", 1, 2 ** 31), ("put", -2 ** 31 - 1, 1),
    ("add", 2, 7), ("add", 2), ("cas", 1, 5, 6), ("cas", 1, None, 3),
    ("cas", 1, 5), ("get", 4), ("get", "x"), ("delete", 4), ("delete",),
    ("watch", 3), ("watch", 1.5), ("enqueue", 7), ("enqueue", -1),
    ("enqueue", "7"), ("dequeue", "settled"), ("dequeue", "unsettled"),
    ("dequeue", "later"), ("settle", 3), ("return", 4), ("purge",),
    ("purge", 9), ("attach", 5, 2), ("attach", 5), ("cancel", 5),
    ("down", 5), ("checkout", 5), ("credit", 5, 3), ("credit", "a", 3),
    ("bogus", 1), (), "put", None, 7, ["put", 1, 2], ("put", [1], 2)]

HOST_QUERIES = [("get", 3), ("get", -1), ("watchers", 2), ("watchers", "x"),
                ("size",), (), None, "get", ("get", 2 ** 40)]


def _encoded(fn, x):
    """``fn(x)`` as numpy, or the exception type it raised."""
    try:
        return np.asarray(fn(x))
    except Exception as e:  # noqa: BLE001 -- both packages must agree
        return type(e).__name__


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_encoders_match_reference(name):
    ref_m, port_m = MACHINES[name][0](), MACHINES[name][1]()
    pairs = [(ref_m.encode_command, port_m.encode_command, HOST_COMMANDS)]
    if ref_m.query_spec is not None:
        pairs.append((ref_m.encode_query, port_m.encode_query, HOST_QUERIES))
    for ref_fn, port_fn, items in pairs:
        for x in items:
            want, got = _encoded(ref_fn, x), _encoded(port_fn, x)
            if isinstance(want, str):
                assert got == want, (x, got, want)
            else:
                assert_tree_equal(torch.from_numpy(got), want, repr(x))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernels' wrappers check before they build or launch: CPU
    tensors, a wrong dtype or shape, an output that aliases the state, a
    checkout table wider than a warp, or a ring the FIFO kernel cannot
    fold are refused."""
    m = JitKvMachine(16)
    st = m.jit_init(4, CPU)[:, None].contiguous()                # [4,1,16]
    cmds = torch.zeros((4, 1, 3, 4), dtype=torch.int32)
    mask = torch.ones((4, 1, 3), dtype=torch.bool)
    index = torch.zeros((4, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        slot_fold.slot_fold_cuda("kv", cmds, mask, index, st,
                                 st.clone())
    with pytest.raises(ValueError, match="shares memory"):
        slot_fold.slot_fold_cuda("kv", cmds, mask, index, st, st)
    with pytest.raises(TypeError, match="mask"):
        slot_fold.slot_fold_cuda("kv", cmds, mask.to(torch.uint8), index,
                                 st, st.clone())
    with pytest.raises(ValueError, match="commands"):
        slot_fold.slot_fold_cuda("kv", cmds[..., :3], mask, index, st,
                                 st.clone())
    with pytest.raises(ValueError, match="kind"):
        slot_fold.slot_fold_cuda("stream", cmds, mask, index, st,
                                 st.clone())
    f = JitFifoMachine(8, 4, 2)
    fs = {k: v[:, None].contiguous() for k, v in f.jit_init(4, CPU).items()}
    fo = {k: v.clone() for k, v in fs.items()}
    with pytest.raises(ValueError, match="CUDA"):
        fifo_fold.fifo_fold_cuda(cmds[..., :3], mask, fs, fo,
                                 drop_head=False)
    with pytest.raises(ValueError, match="keys"):
        fifo_fold.fifo_fold_cuda(cmds[..., :3], mask, {"buf": fs["buf"]},
                                 fo, drop_head=False)
    # a checkout table wider than a warp, and a ring beyond shared memory
    # whose capacity is not a power of two, are refused before anything
    # is built
    for machine in (JitFifoMachine(8, 33, 2),
                    JitFifoMachine(fifo_fold.MAX_SHARED_RING + 2, 4, 2)):
        big = {k: v[:, None].contiguous()
               for k, v in machine.jit_init(1, CPU).items()}
        with pytest.raises(ValueError, match="takes 1 <= K"):
            fifo_fold.fifo_fold_cuda(cmds[:1, :, :, :3], mask[:1], big,
                                     big, drop_head=False)


def test_cuda_engine_refuses_a_fifo_its_kernel_cannot_fold(monkeypatch):
    """Built for the card, an engine refuses at once a FIFO the fold
    kernel cannot fold (more than 32 checkout slots, or a capacity past
    the shared-memory ring that is no power of two), with the limits in
    the message; it takes any other capacity without a warning, and one
    that is no power of two selects between the fast and the in-order
    fold on the card as on the CPU; on the CPU it takes them all.  (The device is faked: the check comes
    before anything is allocated.)"""
    from ra_tpu_torch.engine import lockstep as port_lockstep
    monkeypatch.setattr(port_lockstep, "resolve_device",
                        lambda device: torch.device("cuda"))
    for m in (JitFifoMachine(fifo_fold.MAX_SHARED_RING + 2, 4, 2),
              JitFifoMachine(64, 33, 2)):
        with pytest.raises(ValueError, match="up to 32 checkout slots and "
                                             "a capacity up to 19328 or a "
                                             "power of two"):
            port_lockstep.LockstepEngine(m, 4, 3)
    cuda = torch.device("cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for q in (12, fifo_fold.MAX_SHARED_RING):
            m = JitFifoMachine(q, 4, 40)
            m.check_device(cuda)
            assert m.fast_fold_on_card
        for m in (JitFifoMachine(2 ** 15, 8, 40), JitFifoMachine(256, 32, 4),
                  JitKvMachine(20000)):
            m.check_device(cuda)
            assert not m.fast_fold_on_card
        JitFifoMachine(fifo_fold.MAX_SHARED_RING + 2, 33, 2).check_device(
            CPU)


# -- the fold kernels on the card ---------------------------------------------

def _on(tree, dev):
    return jax.tree.map(lambda x: x.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MACHINES))
@pytest.mark.parametrize("n,p,a", [(6, 3, 9), (129, 1, 1), (300, 7, 20),
                                   (33, 16, 40)])
def test_fold_kernel_matches_plain_on_card(cuda_device, name, n, p, a):
    """The machine's in-order fold on the card (its fold kernel) against
    the plain version on the same inputs, on mixed windows and on the
    clean ones the reference's fast fold takes, and for the FIFO on the
    hard windows: every leaf equal, and one launch a call."""
    port_m, gen = MACHINES[name][1](), MACHINES[name][2]
    rng = np.random.default_rng(n + p + a)
    st = jax.tree.map(lambda x: x[:, None].expand(
        (n, p) + x.shape[1:]).contiguous(), port_m.jit_init(n, CPU))
    for clean in (False, True, False):
        cmd = torch.from_numpy(gen(rng, (n, a), clean=clean)
                               .astype(np.int32))
        cmds = cmd[:, None].expand((n, p) + cmd.shape[1:])
        mask = torch.from_numpy(rng.random((n, p, a)) < 0.85)
        index = torch.from_numpy(
            rng.integers(0, 50, (n, 1, a)).astype(np.int32)).expand(n, p, a)
        meta = {"index": index, "term": torch.ones((n, 1, 1),
                                                   dtype=torch.int32)}
        want = port_m.sequential_window_fold(meta, cmds, mask, st)
        mod = fifo_fold if name.startswith("fifo") else slot_fold
        before = mod.LAUNCHES
        got = port_m.in_order_fold(_on(meta, cuda_device),
                                   cmds.to(cuda_device),
                                   mask.to(cuda_device),
                                   _on(st, cuda_device))
        torch.cuda.synchronize()
        assert_tree_equal(_on(got, CPU), jax.tree.map(
            lambda x: x.numpy(), want), f"{name} clean={clean}")
        assert mod.LAUNCHES == before + 1
        st = want
    if not name.startswith("fifo"):
        return
    # the FIFO's hard windows: full, at the int32 edges, equal ranks
    st = None
    for w in range(3):
        meta, cmds, mask, st = hard_fifo_operands(port_m, rng, n, p, a, st)
        want = port_m.sequential_window_fold(meta, cmds, mask, st)
        got = port_m.in_order_fold(_on(meta, cuda_device),
                                   cmds.to(cuda_device),
                                   mask.to(cuda_device),
                                   _on(st, cuda_device))
        torch.cuda.synchronize()
        assert_tree_equal(_on(got, CPU), jax.tree.map(
            lambda x: x.numpy(), want), f"{name} hard window {w}")
        st = want


#: tables past the kernels' shared-memory layouts, which take their
#: device-memory routes: name -> (port machine, fold_operands kind, hard)
WIDE = {
    # a ring too long for shared memory (a power of two), and the longest
    # one kept there (no power of two), one row a block
    "fifo_ring_32768": (lambda: JitFifoMachine(32768, 8, 4), "fifo", True),
    "fifo_ring_19328": (lambda: JitFifoMachine(19328, 8, 4, "drop_head"),
                        "fifo", True),
    # more consumers than a warp has lanes
    "fifo_consumers_40": (lambda: JitFifoMachine(64, 32, 40, "drop_head"),
                          "fifo", True),
    "fifo_consumers_40_random": (lambda: JitFifoMachine(16, 4, 40),
                                 "fifo", False),
    # cell files too wide for one row in shared memory
    "kv_20000": (lambda: JitKvMachine(20000), "kv", False),
    "ttl_kv_9000": (lambda: TtlKvMachine(9000), "ttl_kv", False),
    "registers_70000": (lambda: RegisterMachine(70000), "registers", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE))
def test_fold_kernel_takes_wide_tables_on_card(cuda_device, name):
    """Rings, consumer tables and cell files wider than the kernels keep
    in shared memory or lanes: the kernel on the card equals the plain
    fold on the CPU over three chained windows, one launch a call."""
    make, kind, hard = WIDE[name]
    m = make()
    mod = fifo_fold if kind == "fifo" else slot_fold
    rng = np.random.default_rng(len(name))
    st = None
    for w in range(3):
        meta, cmds, mask, st = fold_operands(m, kind, 5, 3, 40, rng, CPU,
                                             st, hard=hard)
        want = m.sequential_window_fold(meta, cmds, mask, st)
        before = mod.LAUNCHES
        got = m.in_order_fold(_on(meta, cuda_device), cmds.to(cuda_device),
                              mask.to(cuda_device), _on(st, cuda_device))
        torch.cuda.synchronize()
        assert_tree_equal(_on(got, CPU), jax.tree.map(
            lambda x: x.numpy(), want), f"{name} window {w}")
        assert mod.LAUNCHES == before + 1
        st = want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MACHINES))
def test_batch_apply_of_lane_only_state_on_card(cuda_device, name):
    """``jit_apply_batch`` with one leading dim (state [N, ...], a window
    [N, A, C]) on the card: the kernel takes it with a member axis of 1,
    and the result equals the CPU's."""
    port_m, gen = MACHINES[name][1](), MACHINES[name][2]
    rng = np.random.default_rng(len(name))
    n, a = 77, 30
    st = port_m.jit_init(n, CPU)
    for _ in range(2):
        cmds = torch.from_numpy(gen(rng, (n, a), clean=False)
                                .astype(np.int32))
        mask = torch.from_numpy(rng.random((n, a)) < 0.85)
        meta = {"index": torch.arange(a, dtype=torch.int32).expand(n, a),
                "term": torch.ones((n, 1), dtype=torch.int32)}
        want = port_m.jit_apply_batch(meta, cmds, mask, st)
        got = port_m.jit_apply_batch(_on(meta, cuda_device),
                                     cmds.to(cuda_device),
                                     mask.to(cuda_device),
                                     _on(st, cuda_device))
        assert_tree_equal(_on(got, CPU), jax.tree.map(
            lambda x: x.numpy(), want), name)
        st = want


@pytest.mark.cuda
def test_fifo_q12_batch_fold_on_card_matches_reference(cuda_device):
    """A FIFO capacity that is no power of two, heads and tickets at the
    int32 edge (``chip_smoke.fifo_hard_state``), clean windows (enqueue,
    settled dequeue, noop): the card's batch fold keeps the reference's
    choice of fold, and every leaf equals the reference's, window after
    window."""
    from chip_smoke import fifo_hard_state
    ref_m = RefFifo(12, 5, 3)
    port_m = JitFifoMachine(12, 5, 3)
    assert port_m.fast_fold_on_card
    batch = jax.jit(ref_m.jit_apply_batch)
    n, p, a = 129, 3, 40
    rng = np.random.default_rng(12)
    lanes = fifo_hard_state(rng, n, 12, 5, 3)
    rs = {k: np.ascontiguousarray(np.broadcast_to(
        v[:, None], (n, p) + v.shape[1:])) for k, v in lanes.items()}
    for w in range(4):
        cmd = np.stack([rng.integers(0, 3, (n, a)),
                        rng.integers(0, 1000, (n, a)),
                        np.zeros((n, a), np.int64)], -1).astype(np.int32)
        cmds = np.broadcast_to(cmd[:, None], (n, p, a, 3))
        mask = rng.random((n, p, a)) < 0.9
        index = np.ones((n, p, a), np.int32)
        want = batch({"index": jnp.asarray(index), "term": jnp.int32(1)},
                     jnp.asarray(cmds), jnp.asarray(mask),
                     jax.tree.map(jnp.asarray, rs))
        before = fifo_fold.LAUNCHES
        got = port_m.jit_apply_batch(
            {"index": torch.from_numpy(index).to(cuda_device),
             "term": torch.ones((), dtype=torch.int32, device=cuda_device)},
            torch.from_numpy(np.ascontiguousarray(cmds)).to(cuda_device),
            torch.from_numpy(mask).to(cuda_device),
            {k: torch.from_numpy(v).to(cuda_device) for k, v in rs.items()})
        assert fifo_fold.LAUNCHES == before + 1
        assert_tree_equal(_on(got, CPU), want, f"window {w}")
        rs = {k: np.array(v) for k, v in want.items()}
