"""The port's DP (hypo_tpu_torch.poa.dp / cuda_poa) against the JAX
package's three DPs: jax_poa.poa_dp_batch (XLA, int16 cells), the Pallas
kernel in interpret mode (pallas_poa, int32 cells, NEG16 sentinel) and
device_full._dp (XLA, int32 cells, NEG = -2**30).  Inputs come from
numpy seeds; every compared value is an integer, so the tolerance is 0.
bp rows above a window's n_nodes are unspecified and not compared."""
import functools

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.parallel.mesh import make_example_inputs
from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa import jax_poa, pallas_poa
from hypo_tpu_torch.poa import cuda_poa
from hypo_tpu_torch.poa.dp import poa_dp_batch_ref

SC = dict(m=5, n=-4, g=-8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def multi_bucket(B, N, L, P, seed):
    """Multi-predecessor graphs (bench.py's recipe), mixed NW/LOV/ROV
    modes, ragged n_nodes (one inactive window) and ragged arms."""
    rng = np.random.default_rng(seed)
    nc = rng.integers(0, 4, (B, N)).astype(np.int32)
    pr = np.tile(np.arange(N)[None, :, None], (B, 1, P)).astype(np.int32)
    pc = np.where(rng.random((B, N)) < 0.3, rng.integers(2, P + 1, (B, N)),
                  1).astype(np.int32)
    for p in range(1, P):
        pr[:, :, p] = np.maximum(pr[:, :, 0] - rng.integers(1, 8, (B, N)), 0)
    nn = rng.integers(N // 3, N + 1, B).astype(np.int32)
    nn[3] = 0
    ie = rng.random((B, N)) < 0.1
    ie[np.arange(B), np.maximum(nn - 1, 0)] = True
    arm = rng.integers(0, 4, (B, L)).astype(np.int32)
    al = rng.integers(1, L + 1, B).astype(np.int32)
    md = rng.choice([0, 1, 2], B).astype(np.int32)
    return nc, pr, pc, ie, nn, arm, al, md


CASES = {
    # make_example_inputs chains, as test_pallas_poa.py uses them
    "chain": lambda: (make_example_inputs(B=16, N=64, L=64, Pcap=4,
                                          R=8)[:8], 64, 64, 4),
    "chain_B5": lambda: (make_example_inputs(B=5, N=48, L=40, Pcap=8,
                                             R=8)[:8], 48, 40, 8),
    "multi_mixed": lambda: (multi_bucket(13, 56, 44, 8, seed=7), 56, 44, 8),
}


def _assert_equal(bp, mr, bp_ref, mr_ref, n_nodes, what):
    bp_ref, mr_ref = np.asarray(bp_ref), np.asarray(mr_ref)
    assert np.array_equal(mr, mr_ref), what
    for b, nn in enumerate(n_nodes):
        assert np.array_equal(bp[b, :nn + 1], bp_ref[b, :nn + 1]), (what, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_dp_matches_jax_dps(case):
    args, N, L, P = CASES[case]()
    kw = dict(N=N, L=L, P=P, **SC)
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    bp, mr = (x.numpy() for x in poa_dp_batch_ref(*targs, **kw))
    n_nodes = np.asarray(args[4])
    refs = {
        "jax_poa": jax_poa.poa_dp_batch(*args, **kw),
        "pallas_interpret": pallas_poa.poa_dp_batch_pallas(
            *args, interpret=True, **kw),
        "device_full._dp": jax.jit(jax.vmap(functools.partial(
            DF._dp, **kw)))(*args),
    }
    for what, (bp_ref, mr_ref) in refs.items():
        _assert_equal(bp, mr, bp_ref, mr_ref, n_nodes, what)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    args, N, L, P = CASES["multi_mixed"]()
    kw = dict(N=N, L=L, P=P, **SC)
    targs = [torch.as_tensor(a) for a in args]
    before = cuda_poa.poa_dp_batch.launches
    bp, mr = cuda_poa.poa_dp_batch(*targs, **kw)
    bp_ref, mr_ref = poa_dp_batch_ref(*targs, **kw)
    assert torch.equal(bp, bp_ref) and torch.equal(mr, mr_ref)
    assert cuda_poa.poa_dp_batch.launches == before


def test_wrapper_rejects_bad_arguments():
    args, N, L, P = CASES["chain_B5"]()
    kw = dict(N=N, L=L, P=P, **SC)
    targs = [torch.as_tensor(a) for a in args]
    bad = list(targs)
    bad[0] = bad[0].long()
    with pytest.raises(ValueError, match="node_code has dtype"):
        cuda_poa.poa_dp_batch(*bad, **kw)
    bad = list(targs)
    bad[5] = bad[5][:, :-1]
    with pytest.raises(ValueError, match="arm has shape"):
        cuda_poa.poa_dp_batch(*bad, **kw)


@pytest.mark.cuda
def test_dp_kernel_matches_plain_on_card(cuda_device):
    for case in sorted(CASES):
        args, N, L, P = CASES[case]()
        kw = dict(N=N, L=L, P=P, **SC)
        targs = [torch.as_tensor(np.asarray(a), device=cuda_device)
                 for a in args]
        before = cuda_poa.poa_dp_batch.launches
        bp, mr = (x.cpu().numpy() for x in cuda_poa.poa_dp_batch(*targs,
                                                                   **kw))
        assert cuda_poa.poa_dp_batch.launches == before + 1
        bp_ref, mr_ref = poa_dp_batch_ref(*targs, **kw)
        _assert_equal(bp, mr, bp_ref.cpu(), mr_ref.cpu(),
                      np.asarray(args[4]), case)


def counts_bucket(B, N, L, P, seed, reach=40):
    """Graphs whose rows have 0, 1 or P predecessors (rows without one
    lie outside the DP's contract, pred_cnt >= 1, and are held equal all
    the same), reaching up to ``reach`` rows back: within the kernel's
    ring of 16 rows for reach <= 16, beyond it (rows read from the
    device-memory copy) above; mixed modes, ragged sizes."""
    rng = np.random.default_rng(seed)
    nc = rng.integers(0, 6, (B, N)).astype(np.int32)
    pr = np.maximum(np.arange(N)[None, :, None]
                    - rng.integers(0, reach, (B, N, P)), 0).astype(np.int32)
    pr[:, :, 0] = np.arange(N)[None, :]
    pc = rng.choice([0, 1, P], (B, N), p=[0.05, 0.6, 0.35]).astype(np.int32)
    nn = rng.integers(N // 2, N + 1, B).astype(np.int32)
    nn[0], nn[1] = 0, N
    ie = rng.random((B, N)) < 0.1
    ie[np.arange(B), np.maximum(nn - 1, 0)] = True
    arm = rng.integers(0, 6, (B, L)).astype(np.int32)
    al = rng.integers(0, L + 1, B).astype(np.int32)
    md = rng.choice([0, 1, 2], B).astype(np.int32)
    return nc, pr, pc, ie, nn, arm, al, md


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [
    # a small class-0 tile (N, L of class 0), a small exact bucket, an
    # arm wider than 512 columns (2 columns a thread) and a graph
    # smaller than the ring
    (24, 256, 126, 8, (5, -4, -8)),
    (12, 128, 128, 4, (3, -5, -4)),
    (6, 512, 700, 2, (3, -5, -4)),
    (16, 8, 20, 2, (5, -4, -8)),
])
@pytest.mark.parametrize("reach", [8, 40, 300])
def test_dp_kernel_matches_plain_with_pred_counts_0_1_P(cuda_device, bucket,
                                                        reach):
    B, N, L, P, (m, n, g) = bucket
    args = counts_bucket(B, N, L, P, seed=N + L + reach, reach=reach)
    kw = dict(N=N, L=L, P=P, m=m, n=n, g=g)
    targs = [torch.as_tensor(a, device=cuda_device) for a in args]
    bp, mr = (x.cpu().numpy() for x in cuda_poa.poa_dp_batch(*targs, **kw))
    bp_ref, mr_ref = poa_dp_batch_ref(*targs, **kw)
    _assert_equal(bp, mr, bp_ref.cpu(), mr_ref.cpu(), args[4],
                  (bucket, reach))


@pytest.mark.cuda
def test_dp_kernel_refuses_cells_beyond_int16(cuda_device):
    args, N, L, P = CASES["chain_B5"]()
    targs = [torch.as_tensor(np.asarray(a), device=cuda_device)
             for a in args]
    with pytest.raises(ValueError, match="int16 cells"):
        cuda_poa.poa_dp_batch(*targs, N=N, L=L, P=P, m=5, n=-4, g=-400)


@pytest.mark.cuda
def test_dp_kernel_matches_plain_with_scores_near_int16(cuda_device):
    """max(|m|, |n|, |g|) * (N + L) = 24544 at a class-1 shape: beyond
    the NEG16 sentinel's reach, so sentinel candidates can tie real ones
    and enter the kernel's selects; still inside int16."""
    N, L, P = 1024, 510, 8
    args = multi_bucket(6, N, L, P, seed=3)
    kw = dict(N=N, L=L, P=P, m=12, n=-10, g=-16)
    targs = [torch.as_tensor(a, device=cuda_device) for a in args]
    bp, mr = (x.cpu().numpy() for x in cuda_poa.poa_dp_batch(*targs, **kw))
    bp_ref, mr_ref = poa_dp_batch_ref(*targs, **kw)
    _assert_equal(bp, mr, bp_ref.cpu(), mr_ref.cpu(), args[4], kw)


def test_launch_shape_fits_every_dp_bucket():
    """The launch of every shape the port launches fits the card: at
    most 1024 threads covering the L + 1 columns and 227 KB of shared
    memory."""
    shapes = [(256, 126, 8), (1024, 510, 8)] + [
        (N, L, P) for N in (64, 128, 256, 512, 1024)
        for L in (64, 128, 256, 512, 1024) for P in (1, 2, 4, 8)]
    for N, L, P in shapes:
        per = cuda_poa.columns_per_thread(L)
        threads = cuda_poa.launch_threads(L)
        assert threads <= 1024 and threads * per >= L + 1
        assert cuda_poa.smem_bytes(threads * per, N, P) <= 227 * 1024
