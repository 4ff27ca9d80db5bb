"""The port's quorum ops and commit-quorum kernel against the JAX
reference: every plain op against ``ra_tpu.ops.quorum``, the plain
``evaluate_quorum`` against the Pallas kernel run in interpret mode, and
the CUDA kernel against its plain version on the card.  Integer results
must be equal, dtypes included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.ops import quorum as ref
from ra_tpu.ops.pallas_quorum import evaluate_quorum_pallas
from ra_tpu_torch.ops import pallas_quorum as pq
from ra_tpu_torch.ops import quorum as port


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _case(seed, n, p, no_voter_lanes=False):
    rng = np.random.default_rng(seed)
    commit = rng.integers(0, 50, size=(n,)).astype(np.int32)
    match = rng.integers(0, 100, size=(n, p)).astype(np.int32)
    voter = rng.random((n, p)) < 0.8
    voter[:, 0] = True
    if no_voter_lanes:
        voter[rng.random(n) < 0.1] = False
    tstart = rng.integers(0, 80, size=(n,)).astype(np.int32)
    return commit, match, voter, tstart


@jax.jit
def _reference_ops(commit, match, voter, tstart, nxt, last, ok, sent):
    return (ref.agreed_commit(match, voter),
            ref.evaluate_quorum(commit, match, voter, tstart),
            *ref.update_match_next(match, nxt, ok, nxt - 1, nxt + 1),
            ref.election_quorum(ok, voter),
            ref.query_quorum(nxt, voter),
            *ref.pipeline_credit(nxt, match, last, commit, sent, 7, 5))


@pytest.mark.parametrize("p", range(1, 17))
def test_plain_ops_match_reference(p):
    n = 300  # not a multiple of the kernel's 256-lane block
    commit, match, voter, tstart = _case(100 + p, n, p, no_voter_lanes=True)
    assert (~voter.any(axis=1)).any()
    rng = np.random.default_rng(p)
    nxt = (match + rng.integers(1, 6, size=(n, p))).astype(np.int32)
    last = (match.max(axis=1) + rng.integers(0, 9, size=n)).astype(np.int32)
    ok = rng.random((n, p)) < 0.7
    sent = rng.integers(0, 50, size=(n, p)).astype(np.int32)
    T = torch.from_numpy
    want = _reference_ops(commit, match, voter, tstart, nxt, last, ok, sent)
    got = (port.agreed_commit(T(match), T(voter)),
           port.evaluate_quorum(T(commit), T(match), T(voter), T(tstart)),
           *port.update_match_next(T(match), T(nxt), T(ok), T(nxt - 1),
                                   T(nxt + 1)),
           port.election_quorum(T(ok), T(voter)),
           port.query_quorum(T(nxt), T(voter)),
           *port.pipeline_credit(T(nxt), T(match), T(last), T(commit),
                                 T(sent), 7, 5))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _same(g, w)
    # lanes with no voter agree on index 0
    assert (got[0].numpy()[~voter.any(axis=1)] == 0).all()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("n,p", [(64, 3), (200, 5), (1024, 7), (513, 2)])
def test_plain_matches_pallas_kernel(seed, n, p):
    commit, match, voter, tstart = _case(seed, n, p)
    want = evaluate_quorum_pallas(jnp.asarray(commit), jnp.asarray(match),
                                  jnp.asarray(voter), jnp.asarray(tstart),
                                  interpret=True)
    got = port.evaluate_quorum(*map(torch.from_numpy,
                                    (commit, match, voter, tstart)))
    _same(got, want)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    commit, match, voter, tstart = map(torch.from_numpy, _case(4, 40, 5))
    before = pq.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pq.evaluate_quorum_cuda(commit, match, voter, tstart)
    with pytest.raises(TypeError, match="int32"):
        pq.evaluate_quorum_cuda(commit, match.long(), voter, tstart)
    with pytest.raises(TypeError, match="bool"):
        pq.evaluate_quorum_cuda(commit, match, voter.to(torch.uint8), tstart)
    wide = torch.zeros((40, 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="1..16"):
        pq.evaluate_quorum_cuda(commit, wide, wide.bool(), tstart)
    with pytest.raises(ValueError, match="contiguous"):
        pq.evaluate_quorum_cuda(commit, match.t().contiguous().t(), voter,
                                tstart)
    with pytest.raises(ValueError, match="shape"):
        pq.evaluate_quorum_cuda(commit[:39], match, voter, tstart)
    assert pq.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(10_000, 5), (513, 2), (1024, 7),
                                 (4099, 15), (300, 16), (1, 1)])
def test_kernel_matches_plain_on_card(cuda_device, n, p):
    commit, match, voter, tstart = (
        torch.from_numpy(x).to(cuda_device)
        for x in _case(n + p, n, p, no_voter_lanes=True))
    before = pq.LAUNCHES
    got = pq.evaluate_quorum_cuda(commit, match, voter, tstart)
    torch.cuda.synchronize()
    assert pq.LAUNCHES == before + 1
    want = port.evaluate_quorum(commit, match, voter, tstart)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
