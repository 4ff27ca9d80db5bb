"""The port's CounterMachine against ra_tpu.models.CounterMachine on
seeded windows: apply, masked batch apply, query and init.  Equal values
and dtypes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch.models import CounterMachine


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _window(seed, n=16, p=3, a=9):
    rng = np.random.default_rng(seed)
    cmds = rng.integers(-1000, 1000, size=(n, p, a, 1)).astype(np.int32)
    mask = rng.random((n, p, a)) < 0.6
    state = rng.integers(-2**20, 2**20, size=(n, p)).astype(np.int32)
    idx = (rng.integers(1, 50, size=(n, 1, 1)) +
           np.arange(a)[None, None]).astype(np.int32)
    idx = np.broadcast_to(idx, (n, p, a)).copy()
    term = rng.integers(1, 5, size=(n, 1, 1)).astype(np.int32)
    return cmds, mask, state, idx, term


def test_init_matches_reference():
    got = CounterMachine().jit_init(7, torch.device("cpu"))
    _same(got, RefCounter().jit_init(7))


@pytest.mark.parametrize("seed", range(3))
def test_apply_and_batch_apply_match_reference(seed):
    cmds, mask, state, idx, term = _window(seed)
    ref, mac = RefCounter(), CounterMachine()
    T, J = torch.from_numpy, jnp.asarray
    meta_t = {"index": T(idx), "term": T(term)}
    meta_j = {"index": J(idx), "term": J(term)}

    new_t, reply_t = mac.jit_apply({"index": T(idx[..., 0]),
                                    "term": T(term[..., 0])},
                                   T(cmds[:, :, 0]), T(state))
    new_j, reply_j = ref.jit_apply({"index": J(idx[..., 0]),
                                    "term": J(term[..., 0])},
                                   J(cmds[:, :, 0]), J(state))
    _same(new_t, new_j)
    _same(reply_t, reply_j)

    batch_t = mac.jit_apply_batch(meta_t, T(cmds), T(mask), T(state))
    _same(batch_t, ref.jit_apply_batch(meta_j, J(cmds), J(mask), J(state)))
    # the one-shot fold is order-equivalent to the sequential fold
    _same(mac.sequential_window_fold(meta_t, T(cmds), T(mask), T(state)),
          ref.sequential_window_fold(meta_j, J(cmds), J(mask), J(state)))
    assert torch.equal(batch_t, mac.sequential_window_fold(
        meta_t, T(cmds), T(mask), T(state)))


@pytest.mark.parametrize("kr", [1, 4])
def test_query_matches_reference(kr):
    rng = np.random.default_rng(kr)
    state = rng.integers(-2**30, 2**30, size=(11,)).astype(np.int32)
    queries = rng.integers(0, 9, size=(11, kr, 1)).astype(np.int32)
    got = CounterMachine().jit_query(torch.from_numpy(queries),
                                     torch.from_numpy(state))
    _same(got.contiguous(), RefCounter().jit_query(jnp.asarray(queries),
                                                   jnp.asarray(state)))
