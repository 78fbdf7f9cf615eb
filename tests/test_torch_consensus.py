"""The port's heaviest-bundle consensus (hypo_tpu_torch.poa.device_full.
_consensus_wavefront, reached through cuda_consensus.heaviest_bundle on
CPU tensors) against the JAX package's Pallas kernel in interpret mode
(pallas_consensus.heaviest_bundle_pallas) and its XLA wavefront, on graph
states built by the JAX arm steps and carried over with
hypo_tpu_torch.state.  Tolerance 0: every value is an integer.  Entries
past the consensus length are unspecified in the JAX versions (0 in the
port) and not compared."""
import functools

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.pallas_consensus import heaviest_bundle_pallas
from hypo_tpu_torch.poa import cuda_consensus
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.state import state_from_numpy
from test_torch_device_full import jax_arm_steps, tile_inputs

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def jax_states(seed, N, L, K, P, B):
    """A mid-run and the final JAX graph state of one random tile."""
    tile, _specs = tile_inputs(seed, B, K, L, 30, 0.15)
    states = [st for st, _inp in jax_arm_steps(tile, N, L, P)]
    return [states[len(states) // 2], states[-1]]


def port_args(ra, n_nodes):
    return (ra.pred_ranks, ra.pred_w_r, ra.pred_cnt_r, ra.is_end_r,
            ra.node_code_r, ra.node_sup_r, n_nodes,
            ra.rank_of[:, 0].contiguous())


def _assert_prefix_equal(got, want, what):
    codes, sups, ln = (np.asarray(x) for x in got)
    w_codes, w_sups, w_ln = (np.asarray(x) for x in want)
    assert np.array_equal(ln, w_ln), what
    for b, n in enumerate(ln):
        assert np.array_equal(codes[b, :n], w_codes[b, :n]), (what, b)
        assert np.array_equal(sups[b, :n], w_sups[b, :n]), (what, b)


@functools.lru_cache(maxsize=None)
def _jax_fns(N, P):
    return (jax.jit(functools.partial(DF._rank_arrays_batch, N=N)),
            jax.jit(functools.partial(DF._consensus_wavefront, N=N, P=P,
                                      max_branch_iters=N)))


@pytest.mark.parametrize("shape", [(96, 48, 8, 4, 8), (128, 40, 12, 8, 8)])
@pytest.mark.parametrize("when", ["mid_run", "final"])
def test_plain_consensus_matches_pallas_and_wavefront(shape, when):
    N, L, K, P, B = shape
    rank_arrays, wavefront = _jax_fns(N, P)
    st = jax_states(17, N, L, K, P, B)[when == "final"]
    st_t = state_from_numpy(st, CPU)
    ra_j = rank_arrays(st)
    ra_t = TF._rank_arrays_batch(st_t, N)
    for f in DF.RankArrays._fields:
        assert np.array_equal(getattr(ra_t, f).numpy(),
                              np.asarray(getattr(ra_j, f))), f
    got = cuda_consensus.heaviest_bundle(*port_args(ra_t, st_t.n_nodes),
                                         N=N, P=P)
    assert all(x.dtype == torch.int32 for x in got)
    assert all((x[b, n:] == 0).all() for x in got[:2]
               for b, n in enumerate(got[2].tolist()))
    _assert_prefix_equal(got, wavefront(ra_j, st.n_nodes), "wavefront")
    if when == "final":   # the interpreted Pallas kernel takes seconds
        pallas = heaviest_bundle_pallas(
            ra_j.pred_ranks, ra_j.pred_w_r, ra_j.pred_cnt_r, ra_j.is_end_r,
            ra_j.node_code_r, ra_j.node_sup_r, st.n_nodes,
            ra_j.rank_of[:, 0], N=N, P=P, interpret=True)
        _assert_prefix_equal(got, pallas, "pallas_interpret")


def test_wrapper_raises_for_a_device_without_kernel():
    st = TF.init_state(32, 4, 3, torch.device("meta"))
    ra = TF._rank_arrays_batch(st, 32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_consensus.heaviest_bundle(*port_args(ra, st.n_nodes), N=32,
                                       P=4)


@pytest.mark.cuda
def test_consensus_kernel_matches_plain_on_card(cuda_device):
    N, L, K, P, B = 128, 40, 12, 8, 8
    for st in jax_states(17, N, L, K, P, B):
        st_t = state_from_numpy(st, cuda_device)
        ra = TF._rank_arrays_batch(st_t, N)
        args = port_args(ra, st_t.n_nodes)
        before = cuda_consensus.heaviest_bundle.launches
        got = cuda_consensus.heaviest_bundle(*args, N=N, P=P)
        assert cuda_consensus.heaviest_bundle.launches == before + 1
        want = TF._consensus_wavefront(*args, N=N, P=P)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
