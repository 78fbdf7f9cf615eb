"""The port's heaviest-bundle consensus (hypo_tpu_torch.poa.device_full.
_consensus_wavefront, reached through cuda_consensus.heaviest_bundle on
CPU tensors) against the JAX package's Pallas kernel in interpret mode
(pallas_consensus.heaviest_bundle_pallas) and its XLA wavefront, on graph
states built by the JAX arm steps and carried over with
hypo_tpu_torch.state, and on adversarial rank-space graphs made from a
seed (``adversarial_graphs``) that reach every tie rule of kernel 2.
Tolerance 0: every value is an integer.  Entries past the consensus
length are unspecified in the JAX versions (0 in the port) and not
compared.  On the card (``cuda`` marker), kernel 2 against the plain
version on the same inputs, every output entry compared."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.pallas_consensus import heaviest_bundle_pallas
from hypo_tpu_torch.poa import BIG
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


def adversarial_graphs(seed, B, N, P):
    """Rank-space DAGs made from a seed that reach every tie rule of
    kernel 2 (csrc/consensus.cu's header).  Returns numpy arrays in the
    order of heaviest_bundle's arguments: pred_ranks, pred_w_r,
    pred_cnt_r, is_end_r, node_code_r, node_sup_r, n_nodes, rank0.
    - Predecessors lie below their node's rank, -1 in empty slots; 5% of
      nodes are sources, 15% fill all P slots.
    - Weights 0-3 (8% of edges 0, which reaches threshold 0), equal
      across a node's slots in 40% of nodes; 20% of nodes copy the
      previous rank's in-edges, so two nodes tie on score and both tie
      breaks (score, then the later slot) decide.
    - Traps: every successor of a trap prefers a heavier in-edge from a
      node that is not one, and a successor becomes a trap in turn (80%);
      a few seed traps get in-edges heavy enough to top the first pass.
      So the heaviest node is no end node, and branch completion walks a
      chain of traps, a round each.
    - is_end marks the nodes without a successor; rows from n_nodes on
      hold the tile program's padding (rank 0, count 1, end, zeros).
    - n_nodes is 0, 1 and N in windows 0-2.  Windows 3 and 4 are built
      by hand: a first-pass maximum of score 0 that is not an end node
      and a suffix that tops out at 0, so threshold 0 picks rank0; with
      rank0 = 0 every round returns to rank 0 and the N-round cap ends
      branch completion (window 3), with rank0 = 3 an end node does
      (window 4)."""
    rng = np.random.default_rng(seed)
    pr = np.zeros((B, N, P), np.int32)
    pw = np.zeros((B, N, P), np.int32)
    pc = np.ones((B, N), np.int32)
    ie = np.ones((B, N), bool)
    code = np.zeros((B, N), np.int32)
    sup = np.zeros((B, N), np.int32)
    nn = rng.integers(N // 2, N + 1, B).astype(np.int32)
    nn[:3] = (0, 1, N)[:B]
    rank0 = np.full(B, BIG, np.int32)
    for b in range(B):
        n = int(nn[b])
        if n == 0:
            continue
        pr[b, :n] = -1
        code[b, :n] = rng.integers(0, 6, n)
        sup[b, :n] = rng.integers(0, 60, n)
        rank0[b] = rng.integers(0, n)
        for r in range(1, n):
            u = rng.random()
            if u < 0.05:
                continue                                   # a source
            if u < 0.2 and pr[b, r - 1, 0] >= 0:           # a twin
                pr[b, r], pw[b, r], pc[b, r] = (pr[b, r - 1], pw[b, r - 1],
                                                pc[b, r - 1])
                continue
            k = P if rng.random() < 0.15 else int(rng.integers(1, 4))
            k = min(k, r, P)
            lo = max(0, r - 3 * P)
            q = rng.choice(np.arange(lo if r - lo >= k else 0, r), k,
                           replace=False)
            wts = (np.full(k, rng.integers(1, 4)) if rng.random() < 0.4
                   else rng.integers(1, 4, k))
            wts[rng.random(k) < 0.08] = 0
            pr[b, r, :k], pw[b, r, :k], pc[b, r] = q, wts, k
        trap = np.zeros(n, bool)
        trap[rng.choice(n, max(1, n // 16))] = True
        for v in range(1, n):
            k = pc[b, v]
            qs = pr[b, v, :k]
            tp = [p for p in range(k) if qs[p] >= 0 and trap[qs[p]]]
            if not tp:
                continue
            others = [p for p in range(k) if p not in tp and qs[p] >= 0]
            if not others and k < P:
                for _ in range(8):
                    x = int(rng.integers(0, v))
                    if not trap[x] and x not in qs:
                        pr[b, v, k] = x
                        pc[b, v] = k + 1
                        others = [k]
                        break
            if others:
                pw[b, v, tp] = 1
                pw[b, v, others] = np.maximum(pw[b, v, others], 2)
            trap[v] |= rng.random() < 0.8
        for m in np.nonzero(trap)[0][:max(1, n // 16)]:
            pw[b, m, :pc[b, m]] += 20 * N
        has_succ = np.zeros(n, bool)
        for r in range(n):
            qs = pr[b, r, :pc[b, r]]
            has_succ[qs[qs >= 0]] = True
        ie[b, :n] = ~has_succ
    for b, r0 in ((3, 0), (4, 3)):
        if b < B and N >= 4 and P >= 2:
            pr[b], pw[b], pc[b], ie[b] = 0, 0, 1, True
            pr[b, :4] = -1
            pr[b, 2, 0], pw[b, 2, 0] = 0, 1
            pr[b, 3, :2], pw[b, 3, :2], pc[b, 3] = (2, 1), (0, 1), 2
            ie[b, :4] = (False, False, False, True)
            nn[b], rank0[b] = 4, r0
    return pr, pw, pc, ie, code, sup, nn, rank0


def tiled_graphs(seed, B, N, P, distinct):
    """adversarial_graphs of ``distinct`` windows repeated to B."""
    return tuple(np.resize(a, (B,) + a.shape[1:])
                 for a in adversarial_graphs(seed, distinct, N, P))


def jax_rank_arrays(pr, pw, pc, ie, code, sup, rank0):
    """The JAX RankArrays that the JAX consensus versions read."""
    z = jnp.zeros(code.shape, jnp.int32)
    zp = jnp.zeros(pr.shape, jnp.int32)
    return DF.RankArrays(
        order=z, rank_of=z.at[:, 0].set(jnp.asarray(rank0)),
        node_code_r=jnp.asarray(code), node_col_r=z,
        node_sup_r=jnp.asarray(sup), pred_nd_r=zp,
        pred_ranks=jnp.asarray(pr), pred_rows=zp,
        pred_cnt_r=jnp.asarray(pc), pred_w_r=jnp.asarray(pw),
        is_end_r=jnp.asarray(ie))


# (N, P, B, seed)
ADVERSARIAL = {"N32_P4": (32, 4, 16, 0), "N48_P8": (48, 8, 16, 1),
               "N40_P2": (40, 2, 12, 2), "N24_P1": (24, 1, 8, 3)}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_plain_consensus_matches_pallas_on_adversarial_graphs(case):
    N, P, B, seed = ADVERSARIAL[case]
    g = adversarial_graphs(seed, B, N, P)
    got = cuda_consensus.heaviest_bundle(*map(torch.as_tensor, g), N=N,
                                         P=P)
    assert all((x[b, n:] == 0).all() for x in got[:2]
               for b, n in enumerate(got[2].tolist()))
    pr, pw, pc, ie, code, sup, nn, rank0 = g
    ra = jax_rank_arrays(pr, pw, pc, ie, code, sup, rank0)
    _, wavefront = _jax_fns(N, P)
    _assert_prefix_equal(got, wavefront(ra, jnp.asarray(nn)), "wavefront")
    pallas = heaviest_bundle_pallas(
        *(jnp.asarray(a) for a in (pr, pw, pc, ie, code, sup, nn, rank0)),
        N=N, P=P, interpret=True)
    _assert_prefix_equal(got, pallas, "pallas_interpret")


@pytest.mark.parametrize("shape", [(32, 4, 16), (64, 8, 24)])
def test_adversarial_graphs_reach_every_rule(shape):
    """The generator's windows hold what the tie rules need."""
    N, P, B = shape
    pr, pw, pc, ie, code, sup, nn, rank0 = adversarial_graphs(7, B, N, P)
    assert {0, 1, N} <= set(nn.tolist())
    assert (pc == P).any()
    real = np.arange(P)[None, None, :] < pc[:, :, None]
    tied_w = (real[..., 1:] & (pw[..., 1:] == pw[..., :1])).any()
    assert tied_w and (pw[real & (pr >= 0)] == 0).any()
    for b in range(B):
        n = int(nn[b])
        assert (pr[b, :n] < np.arange(n)[:, None]).all()
        assert (pr[b, :n][~real[b, :n]] == -1).all()
        succ = np.zeros(n, bool)
        for r in range(n):
            qs = pr[b, r, :pc[b, r]]
            succ[qs[qs >= 0]] = True
        assert np.array_equal(ie[b, :n], ~succ)
    out = TF._consensus_wavefront(*map(torch.as_tensor, (
        pr, pw, pc, ie, code, sup, nn, rank0)), N=N, P=P, with_rounds=True)
    rounds = out[3].numpy()
    assert rounds[3] == N and rounds[4] == 1     # the hand-built windows
    assert (rounds[5:] >= 2).sum() >= 2 and (rounds[5:] >= 1).mean() >= 0.5


def test_kernel_holds_every_shape_it_is_given():
    # class 0, class 1 (csrc/consensus.cu: 13.75 KB and 55 KB a window)
    assert cuda_consensus.smem_bytes(256, 8) == 14080
    assert cuda_consensus.smem_bytes(1024, 8) == 56320
    for N, P in ((256, 8), (1024, 8), (24, 1), (4000, 8)):
        cuda_consensus.check_shape(N, P)
    for N, P in ((256, 9), (256, 0), (5000, 8), (40000, 1)):
        with pytest.raises(ValueError, match="the kernel needs"):
            cuda_consensus.check_shape(N, P)


def test_wrapper_checks_its_arguments():
    g = [torch.as_tensor(a) for a in adversarial_graphs(0, 4, 16, 2)]
    with pytest.raises(ValueError, match="pred_w_r has dtype"):
        cuda_consensus.heaviest_bundle(*g[:1], g[1].long(), *g[2:], N=16,
                                       P=2)
    with pytest.raises(ValueError, match="rank0 has shape"):
        cuda_consensus.heaviest_bundle(*g[:7], g[7][:3], N=16, P=2)


# (B, N, P, distinct windows): the class shapes and the small ones
CARD_ADVERSARIAL = {"class0": (2048, 256, 8, 128), "class1": (256, 1024, 8, 32),
                    "N48_P8": (15, 48, 8, 15), "N32_P4": (16, 32, 4, 16),
                    "N64_P2": (16, 64, 2, 16), "N24_P1": (8, 24, 1, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_ADVERSARIAL))
def test_consensus_kernel_on_adversarial_graphs_on_card(cuda_device, case):
    B, N, P, distinct = CARD_ADVERSARIAL[case]
    args = [torch.as_tensor(a, device=cuda_device)
            for a in tiled_graphs(11, B, N, P, distinct)]
    before = cuda_consensus.heaviest_bundle.launches
    got = cuda_consensus.heaviest_bundle(*args, N=N, P=P)
    assert cuda_consensus.heaviest_bundle.launches == before + 1
    want = TF._consensus_wavefront(*args, N=N, P=P)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
