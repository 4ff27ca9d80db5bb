"""The port's DedupCounterMachine (``ra_tpu_torch/wire/dedup.py``) against
the JAX reference (``ra_tpu/wire/dedup.py``): the same numpy-seeded
inputs go through both, and every state leaf and reply must be equal,
dtypes included (``np.array_equal``).

Twins of the reference's ``test_dedup_machine_batch_fold_matches_
sequential`` and ``test_dedup_machine_host_path_dedups``
(``tests/test_wire.py``), held against the reference as well as against
the sequential fold; a restored negative watermark; a value sum that
wraps int32; and the machine in the lane engine against the reference's
engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.core.machine import ApplyMeta
from ra_tpu.engine import lockstep as ref_lockstep
from ra_tpu.wire.dedup import DedupCounterMachine as RefDedup
from ra_tpu_torch.core.tree import tree_leaves
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.wire.dedup import DedupCounterMachine
from test_torch_engine import assert_same, host_verbs


def to_port(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def assert_tree_equal(got, want, what):
    gl = [x.numpy() for x in tree_leaves(got)]
    wl = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), what
    for j, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, j)
        assert np.array_equal(g, w), (what, j)


def _window(rng, lead, a, slots, delta=None):
    cmds = np.zeros(lead + (a, 3), np.int32)
    cmds[..., 0] = rng.integers(-1, slots + 1, lead + (a,))  # bad slots
    cmds[..., 1] = rng.integers(0, 6, lead + (a,))           # dups, stale
    cmds[..., 2] = rng.integers(1, 5, lead + (a,)) if delta is None \
        else delta
    return cmds


@pytest.mark.parametrize("lead", [(4,), (4, 3)])
def test_dedup_machine_batch_fold_matches_sequential(lead):
    """The vectorised window fold is exactly order-equivalent to the
    sequential masked apply (duplicates, stale replays and inversions in
    one window), and both equal the reference's."""
    ref, mac = RefDedup(slots=8), DedupCounterMachine(slots=8)
    rng = np.random.default_rng(0)
    a = 12
    for trial in range(8):
        state = {"value": rng.integers(0, 5, lead).astype(np.int32),
                 "seq": rng.integers(0, 3, lead + (8,)).astype(np.int32)}
        cmds = _window(rng, lead, a, 8)
        mask = rng.random(lead + (a,)) < 0.8
        meta = {"index": np.zeros(lead + (a,), np.int32),
                "term": np.zeros(lead + (1,), np.int32)}
        pargs = ({k: torch.from_numpy(v) for k, v in meta.items()},
                 torch.from_numpy(cmds), torch.from_numpy(mask),
                 to_port(state))
        rargs = (jax.tree.map(jnp.asarray, meta), jnp.asarray(cmds),
                 jnp.asarray(mask), jax.tree.map(jnp.asarray, state))
        fast = mac.jit_apply_batch(*pargs)
        slow = mac.sequential_window_fold(*pargs)
        assert_tree_equal(fast, jax.tree.map(lambda t: t.numpy(), slow),
                          f"batch vs sequential, trial {trial}")
        assert_tree_equal(fast, ref.jit_apply_batch(*rargs),
                          f"batch vs reference, trial {trial}")
        assert_tree_equal(slow, ref.sequential_window_fold(*rargs),
                          f"sequential vs reference, trial {trial}")


def test_dedup_machine_host_path_dedups():
    """The reference's host-path sequence, command by command through
    ``jit_apply`` on one lane: a duplicate op is skipped, another slot
    counts, a fresh op counts; replies equal the reference's host
    path's."""
    ref = RefDedup(slots=4)
    rstate = ref.init({})
    mac = DedupCounterMachine(slots=4)
    state = mac.jit_init(1, torch.device("cpu"))
    meta = ApplyMeta(index=1, term=1)
    replies = []
    for cmd in ((0, 1, 10), (0, 1, 10), (1, 1, 5), (0, 3, 1)):
        rstate, want = ref.apply(meta, cmd, rstate)
        state, got = mac.jit_apply({}, mac.encode_command(cmd)[None], state)
        assert mac.decode_reply(got[0]) == want
        replies.append(want)
    assert replies == [10, 10, 15, 16]
    assert_tree_equal(state, jax.tree.map(lambda x: jnp.asarray(x)[None],
                                          rstate), "host path state")
    with pytest.raises(OverflowError):
        mac.encode_command((0, 1, 2 ** 31))


def test_restored_negative_watermark_folds_as_reference():
    """A state restored with negative per-slot watermarks: every row of a
    window scatters into its slot (a stale row scatters 0), so a negative
    watermark a window names comes out 0 or more, as the reference's."""
    ref, mac = RefDedup(slots=6), DedupCounterMachine(slots=6)
    rng = np.random.default_rng(3)
    lead, a = (5, 3), 10
    state = {"value": np.zeros(lead, np.int32),
             "seq": rng.integers(-9, 0, lead + (6,)).astype(np.int32)}
    cmds = _window(rng, lead, a, 6)
    cmds[..., 1] = rng.integers(-12, 2, lead + (a,))     # ops at or below
    mask = rng.random(lead + (a,)) < 0.9
    pargs = (None, torch.from_numpy(cmds), torch.from_numpy(mask),
             to_port(state))
    rargs = (None, jnp.asarray(cmds), jnp.asarray(mask),
             jax.tree.map(jnp.asarray, state))
    got = mac.jit_apply_batch(*pargs)
    assert_tree_equal(got, ref.jit_apply_batch(*rargs), "batch")
    assert (got["seq"] >= state["seq"].min()).all()
    assert ((got["seq"] == 0) & (torch.from_numpy(state["seq"]) < 0)).any()
    new, rep = mac.jit_apply({}, torch.from_numpy(cmds[..., 0, :]),
                             to_port(state))
    assert_tree_equal((new, rep), ref.jit_apply(
        {}, jnp.asarray(cmds[..., 0, :]), jax.tree.map(jnp.asarray, state)),
        "apply")


def test_value_sum_wraps_int32_as_reference():
    """Deltas whose window sum passes 2**31: the value wraps modulo 2**32
    in both packages (torch's int32 sum would widen to int64)."""
    ref, mac = RefDedup(slots=4), DedupCounterMachine(slots=4)
    lead, a = (3, 2), 8
    state = {"value": np.full(lead, 2 ** 31 - 5, np.int32),
             "seq": np.zeros(lead + (4,), np.int32)}
    cmds = np.zeros(lead + (a, 3), np.int32)
    cmds[..., 0] = np.arange(a) % 4
    cmds[..., 1] = np.arange(a) // 4 + 1
    cmds[..., 2] = 2 ** 30
    mask = np.ones(lead + (a,), bool)
    got = mac.jit_apply_batch(None, torch.from_numpy(cmds),
                              torch.from_numpy(mask), to_port(state))
    want = ref.jit_apply_batch(None, jnp.asarray(cmds), jnp.asarray(mask),
                               jax.tree.map(jnp.asarray, state))
    assert_tree_equal(got, want, "wrapped batch")
    assert got["value"].dtype == torch.int32
    assert int(got["value"][0, 0]) == \
        (2 ** 31 - 5 + 8 * 2 ** 30 + 2 ** 31) % 2 ** 32 - 2 ** 31
    new, rep = mac.jit_apply({}, torch.from_numpy(cmds[..., 0, :]),
                             to_port(state))
    assert_tree_equal((new, rep), ref.jit_apply(
        {}, jnp.asarray(cmds[..., 0, :]), jax.tree.map(jnp.asarray, state)),
        "wrapped apply")


def test_engine_matches_reference():
    """16 lanes x 3 members over DedupCounterMachine(16): client ops with
    duplicates and stale replays through failures, recovery and
    elections; every leaf and aux key equal after every step."""
    n, p, kc = 16, 3, 8
    kw = dict(write_delay=1, max_step_cmds=kc, ring_capacity=32)
    ref = ref_lockstep.LockstepEngine(RefDedup(16), n, p, **kw)
    port = port_lockstep.LockstepEngine(DedupCounterMachine(16), n, p,
                                        device="cpu", **kw)
    rng = np.random.default_rng(9)
    failed = {}
    for i in range(30):
        host_verbs(rng, ref, port, failed, i)
        n_new = rng.integers(0, kc + 1, n).astype(np.int32)
        pay = _window(rng, (n,), kc, 16)
        pay[..., 1] += i // 3
        step_kw = {}
        if rng.random() < 0.3:
            step_kw["elect_mask"] = rng.random(n) < 0.2
        assert_same(ref, port, ref.step(n_new, pay, **step_kw),
                    port.step(n_new, pay, **step_kw), what=f"step {i}")
    assert int(port.state.total_committed.sum()) > 0
