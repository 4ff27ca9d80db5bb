"""The port's commit phase (phases 4-4b of a lockstep step) against the
JAX reference: the plain ``commit_phase`` against ``ra_tpu.ops.quorum``
composed in the order of ``ra_tpu/engine/lockstep.py`` phases 4-4b, with
the XLA commit quorum and with the Pallas kernel in interpret mode; the
fused CUDA kernel against its plain version on the card.  Integer and
bool results must be equal, dtypes included."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.ops import quorum as ref
from ra_tpu.ops.pallas_quorum import evaluate_quorum_pallas
from ra_tpu_torch.ops import commit_phase as cpm

SHAPES = [(10_000, 5), (513, 2), (1024, 7), (4099, 15), (2048, 16)]
NAMES = [name for name, _dtype, _kind in cpm.INPUTS]


def reference_commit_phase(quorum_fn, match0, next0, last_index,
                           last_written, commit, peer_query, active, voter,
                           term_start, leader_slot, elect_ok, leader_up,
                           total_committed, read_clock, lease_until, n_read,
                           read_n, read_ix, read_reg, query_mask,
                           query_index, read_tok, *, lease_ttl, Kr,
                           supports_read):
    """Phases 4-4b of ``ra_tpu/engine/lockstep.py::_step`` (:450-535) on
    its own inputs, in JAX."""
    N = match0.shape[0]

    def take(x, slot):
        return jnp.take_along_axis(x, slot[:, None], axis=-1)[:, 0]

    match, _ = ref.update_match_next(match0, next0, active, last_written,
                                     last_index + 1)
    next_index = jnp.where(active, last_index + 1, next0)
    leader_commit0 = take(commit, leader_slot)
    new_leader_commit = quorum_fn(leader_commit0, match, voter, term_start)
    new_commit = jnp.minimum(new_leader_commit[:, None], last_index)
    new_commit = jnp.where(active, jnp.maximum(new_commit, commit), commit)
    delta = take(new_commit, leader_slot) - leader_commit0

    read_clock = read_clock + 1
    lease_q = ref.election_quorum(active & voter, voter)
    lease_until = jnp.where(elect_ok, 0, lease_until)
    lease_until = jnp.where(lease_q & leader_up,
                            jnp.maximum(lease_until, read_clock + lease_ttl),
                            lease_until)
    if supports_read:
        acc_lane = (n_read > 0) & leader_up & (read_n == 0)
    else:
        acc_lane = jnp.zeros((N,), jnp.bool_)
    r_acc = jnp.where(acc_lane, jnp.minimum(n_read, Kr), 0)

    query_index = query_index + jnp.where(query_mask | acc_lane, 1, 0)
    peer_q0 = jnp.where(elect_ok[:, None], 0, peer_query)
    peer_query = jnp.where(active, query_index[:, None], peer_q0)
    return dict(
        match=match, next_index=next_index, commit=new_commit,
        peer_query=peer_query, total_committed=total_committed + delta,
        delta=delta, leader_commit=leader_commit0 + delta,
        read_clock=read_clock, lease_until=lease_until,
        lease_ok=read_clock < lease_until, acc_lane=acc_lane,
        r_shed_now=n_read - r_acc,
        read_ix=jnp.where(acc_lane, leader_commit0, read_ix),
        read_reg=jnp.where(acc_lane, read_clock, read_reg),
        read_n1=jnp.where(acc_lane, r_acc, read_n),
        query_index=query_index,
        read_tok=jnp.where(acc_lane, query_index, read_tok),
        query_agreed=ref.query_quorum(peer_query, voter))


def _pallas_quorum(commit, match, voter, tstart):
    return evaluate_quorum_pallas(commit, match, voter, tstart,
                                  interpret=True)


def _assert_equal(got: cpm.CommitPhase, want: dict, what):
    assert sorted(want) == sorted(got._fields)
    for k in got._fields:
        g, w = getattr(got, k).numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, k)


@pytest.mark.parametrize("supports_read", [True, False])
@pytest.mark.parametrize("p", [1, 2, 5, 7, 15, 16])
def test_plain_matches_reference(p, supports_read):
    n, Kr, ttl = 300, 3, 4      # 300: not a multiple of a kernel block
    inputs = cpm.sample_inputs(n, p, seed=10 * p + supports_read, Kr=Kr)
    kw = dict(lease_ttl=ttl, Kr=Kr, supports_read=supports_read)
    got = cpm.commit_phase(*map(torch.from_numpy, inputs), **kw)
    for quorum_fn in (ref.evaluate_quorum, _pallas_quorum):
        want = reference_commit_phase(quorum_fn,
                                      *map(jnp.asarray, inputs), **kw)
        _assert_equal(got, want, quorum_fn.__name__)
    # the inputs reach every branch the kernel has
    args = dict(zip(NAMES, inputs))
    assert (~args["voter"].any(axis=1)).any()
    assert (~args["active"]).any() and args["elect_ok"].any()
    assert (~args["leader_up"]).any()
    assert got.delta.numpy().any() and got.lease_ok.numpy().any()
    assert (~got.lease_ok.numpy()).any()
    acc, shed = got.acc_lane.numpy(), got.r_shed_now.numpy()
    assert acc.any() == supports_read and (shed > 0).any()
    if supports_read:
        assert ((args["n_read"] > Kr) & acc).any()     # cut to the window
        assert ((args["read_n"] > 0) & (args["n_read"] > 0)).any()


def test_inputs_follow_the_plain_signature():
    params = list(inspect.signature(cpm.commit_phase).parameters)
    assert params[:len(cpm.INPUTS)] == list(NAMES)
    assert params[len(cpm.INPUTS):] == ["lease_ttl", "Kr", "supports_read"]
    # the ctypes argument block: one pointer per input and per output
    assert len(cpm._Args._fields_) == len(cpm.INPUTS) + \
        len(cpm.CommitPhase._fields)


def test_dispatch_on_cpu_takes_plain_version():
    args = tuple(map(torch.from_numpy, cpm.sample_inputs(77, 5, seed=3)))
    kw = dict(lease_ttl=8, Kr=4, supports_read=True)
    before = cpm.LAUNCHES
    got = cpm.commit_phase_dispatch(*args, **kw)
    assert cpm.LAUNCHES == before
    want = cpm.commit_phase(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    args = list(map(torch.from_numpy, cpm.sample_inputs(40, 5, seed=4)))
    kw = dict(lease_ttl=8, Kr=4, supports_read=True)
    before = cpm.LAUNCHES

    def with_arg(i, t):
        return args[:i] + [t] + args[i + 1:]

    with pytest.raises(ValueError, match="CUDA"):
        cpm.commit_phase_cuda(*args, **kw)
    with pytest.raises(TypeError, match="int32"):
        cpm.commit_phase_cuda(*with_arg(2, args[2].long()), **kw)
    with pytest.raises(TypeError, match="bool"):
        cpm.commit_phase_cuda(*with_arg(6, args[6].to(torch.uint8)), **kw)
    with pytest.raises(ValueError, match="shape"):
        cpm.commit_phase_cuda(*with_arg(9, args[9][:39]), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cpm.commit_phase_cuda(
            *with_arg(4, args[4].t().contiguous().t()), **kw)
    wide = [torch.zeros((40, 17), dtype=t.dtype) if t.dim() == 2 else t
            for t in args]
    with pytest.raises(ValueError, match="1..16"):
        cpm.commit_phase_cuda(*wide, **kw)
    with pytest.raises(TypeError, match="22 tensors"):
        cpm.commit_phase_cuda(*args[:-1], **kw)
    with pytest.raises(ValueError, match="expected all"):
        cpm.commit_phase_dispatch(*with_arg(12, args[12].to("meta")), **kw)
    assert cpm.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("supports_read", [True, False])
@pytest.mark.parametrize("n,p", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, n, p, supports_read):
    args = tuple(torch.from_numpy(x).to(cuda_device)
                 for x in cpm.sample_inputs(n, p, seed=n + p, Kr=4))
    kw = dict(lease_ttl=3, Kr=4, supports_read=supports_read)
    before = cpm.LAUNCHES
    got = cpm.commit_phase_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cpm.LAUNCHES == before + 1
    want = cpm.commit_phase(*args, **kw)
    for k, g, w in zip(cpm.CommitPhase._fields, got, want):
        assert g.dtype == w.dtype, k
        assert torch.equal(g, w), k
