"""Kernel 3, the backpointer traceback, and its two emitters.

Exact mode's device call: the port's DP + traceback
(hypo_tpu_torch.poa.dp.poa_dp_tb_batch_ref, and poa.cuda_tb, whose
wrappers take the plain versions for CPU tensors) against
hypo_tpu.poa.jax_poa.poa_dp_tb_batch, on graphs that hypo_tpu.poa.Graph
builds from mutated random sequences, over all S = N + L + 1 traceback
entries.  The tile program's walk: the port's plain version
(poa.dp.poa_tb_matched_ref, behind poa.cuda_tb.poa_tb_matched) against
hypo_tpu.poa.device_full._traceback_matched_batch on the bp of the JAX
tile program's DP, and against matched rebuilt from exact mode's walk.
Inputs come from numpy seeds; every compared value is an integer, so the
tolerance is 0."""
import functools

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.poa import LOV, NW, ROV, Graph, PoaAligner, jax_poa
from hypo_tpu.poa import device_full as DF
from hypo_tpu_torch.poa import cuda_poa, cuda_tb
from hypo_tpu_torch.poa import dp as tdp
from test_torch_device_full import SC, jax_arm_steps, tile_inputs
from test_torch_dp import multi_bucket

SHORT = (5, -4, -8)
LONG = (3, -5, -4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _mutate(rng, seq, rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(str(rng.choice(list("ACGT"))))
        out.append(c)
    return "".join(out)


def graph_bucket(seed, B, N, L, P, scores, n_seqs, base_len, rate):
    """B windows, each a Graph of n_seqs mutated copies of a random base
    (J/O-framed NW arms), queried with one more copy in mode NW, LOV or
    ROV (in turn); returns the DP inputs with each window's rank ids.
    Every graph has a node with more than P // 2 predecessors, so the
    bucket is the one jax's runner would pick."""
    rng = np.random.default_rng(seed)
    aligner = PoaAligner(*scores)
    cols = {k: [] for k in ("nc", "pr", "pc", "ie", "nn", "arm", "al",
                            "md", "rid")}
    while len(cols["nn"]) < B:
        base = "".join(rng.choice(list("ACGT"), base_len))
        g = Graph()
        for k in range(n_seqs):
            s = "J" + _mutate(rng, base, rate) + "O"
            g.add_alignment(aligner.align(s, g, NW) if k else [], s)
        ext = tdp.extract_graph_arrays(g, N, P)
        if ext is None or not P // 2 < int(ext[2].max()) <= P:
            continue
        md = (NW, LOV, ROV)[len(cols["nn"]) % 3]
        q = _mutate(rng, base, rate)
        cut = len(q) // 2
        q = {NW: "J" + q + "O", LOV: "J" + q[:cut], ROV: q[cut:] + "O"}[md]
        q = q[:L]
        codes = tdp.encode_global(q)
        arm = np.zeros(L, np.int32)
        arm[:len(codes)] = codes
        for k, v in zip(("nc", "pr", "pc", "ie", "nn", "arm", "al", "md",
                         "rid"),
                        (*ext, arm, len(codes), md,
                         np.array(g.rank_to_node_id, np.int32))):
            cols[k].append(v)
    args = [np.stack(cols[k]).astype(bool if k == "ie" else np.int32)
            for k in ("nc", "pr", "pc", "ie", "nn", "arm", "al", "md")]
    return args, cols["rid"]


# name: (seed, B, N, L, P, scores, sequences per graph, base length,
# mutation rate)
CASES = {
    "short_N64_L64_P1": (1, 6, 64, 64, 1, SHORT, 3, 40, 0.0),
    "short_N128_L64_P2": (2, 6, 128, 64, 2, SHORT, 4, 50, 0.08),
    "short_N128_L128_P4": (3, 5, 128, 128, 4, SHORT, 8, 70, 0.2),
    "long_N256_L128_P8": (4, 3, 256, 128, 8, LONG, 16, 100, 0.35),
    "long_N1024_L512_P4": (5, 3, 1024, 512, 4, LONG, 4, 420, 0.1),
    # the largest exact bucket, at both score sets: short scores reach
    # the int16 bound |g| * (N + L) = 16384 of jax_poa's cells
    "long_N1024_L1024_P4": (6, 2, 1024, 1024, 4, LONG, 3, 700, 0.1),
    "short_N1024_L1024_P4": (7, 2, 1024, 1024, 4, SHORT, 3, 700, 0.1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_tb_matches_jax_poa(case):
    seed, B, N, L, P, (m, n, g), nseq, blen, rate = CASES[case]
    args, rank_ids = graph_bucket(seed, B, N, L, P, (m, n, g), nseq, blen,
                                  rate)
    kw = dict(N=N, L=L, P=P, m=m, n=n, g=g)
    want = [np.asarray(x) for x in jax_poa.poa_dp_tb_batch(*args, **kw)]
    got = [x.numpy() for x in tdp.poa_dp_tb_batch_ref(
        *(torch.from_numpy(a) for a in args), **kw)]
    for name, a, b in zip(("ti", "tj", "steps", "max_row"), got, want):
        assert a.shape == b.shape and np.array_equal(a, b), (case, name)
    assert got[0].dtype == np.int16 and got[2].dtype == np.int32
    for b in range(B):
        aln = tdp.alignment_from_steps(got[0][b], got[1][b], got[2][b],
                                       rank_ids[b])
        assert aln == jax_poa.alignment_from_steps(
            want[0][b], want[1][b], int(want[2][b]), rank_ids[b])


def test_host_helpers_match_jax_poa():
    rng = np.random.default_rng(8)
    seq = "".join(rng.choice(list("ACGTJO"), 300))
    assert np.array_equal(tdp.encode_global(seq),
                          jax_poa.encode_global(seq))
    assert tdp.encode_global(seq).dtype == np.int32
    with pytest.raises(KeyError):
        tdp.encode_global("ACGNT")
    aligner = PoaAligner(*SHORT)
    g = Graph()
    base = "".join(rng.choice(list("ACGT"), 60))
    for k in range(6):
        s = "J" + _mutate(rng, base, 0.2) + "O"
        g.add_alignment(aligner.align(s, g, NW) if k else [], s)
    for N, P in ((128, 8), (128, 1), (32, 8)):
        got = tdp.extract_graph_arrays(g, N, P)
        want = jax_poa.extract_graph_arrays(g, N, P)
        assert (got is None) == (want is None), (N, P)
        if got is not None:
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["short_N128_L64_P2", "short_N128_L128_P4",
                                  "long_N256_L128_P8"])
def test_traceback_from_bp_matches_jax_poa(case):
    """The host walk of one window's backpointer plane
    (poa.dp.traceback_from_bp) equals jax_poa.traceback_from_bp on the
    JAX DP's bp, in NW, LOV and ROV (the bucket's modes cycle), and both
    equal the alignment of the port's batched walk on the same bp."""
    seed, B, N, L, P, (m, n, g), nseq, blen, rate = CASES[case]
    args, rank_ids = graph_bucket(seed, B, N, L, P, (m, n, g), nseq, blen,
                                  rate)
    kw = dict(N=N, L=L, P=P, m=m, n=n, g=g)
    bp, max_row = (np.array(x) for x in jax_poa.poa_dp_batch(*args, **kw))
    ti, tj, steps = (x.numpy() for x in tdp.poa_tb_batch_ref(
        *(torch.from_numpy(a) for a in (bp, args[1], max_row, args[6],
                                        args[7])), N=N, L=L, P=P))
    modes = set()
    for b in range(B):
        walk = (bp[b], args[1][b], rank_ids[b].tolist(), int(args[6][b]),
                int(args[7][b]), int(max_row[b]), P)
        got = tdp.traceback_from_bp(*walk)
        assert got == jax_poa.traceback_from_bp(*walk), (case, b)
        assert got == tdp.alignment_from_steps(ti[b], tj[b], int(steps[b]),
                                               rank_ids[b]), (case, b)
        modes.add(int(args[7][b]))
    assert modes == {NW, LOV, ROV}


def test_wrappers_take_plain_versions_for_cpu_tensors(monkeypatch):
    """poa_tb_batch runs the plain traceback on CPU tensors without
    counting a launch; poa_dp_tb_batch gives the same results when its
    memory bound cuts the batch into one-window launches."""
    args, _rid = graph_bucket(3, 5, 128, 128, 4, SHORT, 8, 70, 0.2)
    kw = dict(N=128, L=128, P=4)
    targs = [torch.from_numpy(a) for a in args]
    want = tdp.poa_dp_tb_batch_ref(*targs, **kw, m=5, n=-4, g=-8)
    before = cuda_tb.poa_tb_batch.launches
    bp, max_row = tdp.poa_dp_batch_ref(*targs, **kw, m=5, n=-4, g=-8)
    got = cuda_tb.poa_tb_batch(bp, targs[1], max_row, targs[6], targs[7],
                               **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    monkeypatch.setattr(cuda_tb, "MAX_CHUNK_BYTES", 5 * 129 * 129)
    got = cuda_tb.poa_dp_tb_batch(*targs, **kw, m=5, n=-4, g=-8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cuda_tb.poa_tb_batch.launches == before


def _tb_args(device, B=3, N=16, L=10, P=4):
    i = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device=device)
    bp = torch.zeros((B, N + 1, L + 1), dtype=torch.int8, device=device)
    return (bp, i(B, N, P), i(B), i(B), i(B)), dict(N=N, L=L, P=P)


def test_tb_wrapper_raises_for_a_device_without_kernel():
    args, kw = _tb_args(torch.device("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_tb.poa_tb_batch(*args, **kw)


def test_tb_wrapper_rejects_bad_arguments():
    args, kw = _tb_args(torch.device("cpu"))
    bad = list(args)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(ValueError, match="bp has dtype"):
        cuda_tb.poa_tb_batch(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1][:, :, :2]
    with pytest.raises(ValueError, match="pred_rows has shape"):
        cuda_tb.poa_tb_batch(*bad, **kw)


@pytest.mark.cuda
def test_tb_wrapper_raises_on_cuda_tensors_it_cannot_take(cuda_device):
    args, kw = _tb_args(cuda_device)
    bad = list(args)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(ValueError, match="bp has dtype"):
        cuda_tb.poa_tb_batch(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1][:, :, :2].contiguous()
    with pytest.raises(ValueError, match="pred_rows has shape"):
        cuda_tb.poa_tb_batch(*bad, **kw)
    bad = list(args)
    bad[2] = bad[2].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_tb.poa_tb_batch(*bad, **kw)


@pytest.mark.cuda
def test_dp_tb_kernels_match_plain_on_card(cuda_device):
    for case in ("short_N128_L128_P4", "long_N1024_L1024_P4"):
        seed, B, N, L, P, (m, n, g), nseq, blen, rate = CASES[case]
        args, _rid = graph_bucket(seed, B, N, L, P, (m, n, g), nseq, blen,
                                  rate)
        kw = dict(N=N, L=L, P=P, m=m, n=n, g=g)
        targs = [torch.from_numpy(a).to(cuda_device) for a in args]
        before = cuda_tb.poa_tb_batch.launches
        got = cuda_tb.poa_dp_tb_batch(*targs, **kw)
        assert cuda_tb.poa_tb_batch.launches == before + 1
        want = tdp.poa_dp_tb_batch_ref(*targs, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu()), case


# -- the tile program's walk (poa_tb_matched) --------------------------------

# the tile of the walk cases: (N, L, K, P, B, truth length, error rate);
# the inputs are those of its fourth arm step
WALK_TILE = (96, 48, 8, 4, 14, 30, 0.15)
WALK_CASES = ("NW", "LOV", "ROV", "inactive", "empty_graph", "row0_run")


@functools.lru_cache(maxsize=None)
def _walk_step():
    """The JAX tile program's state before its fourth arm step, and that
    step's (arm, arm_len, mode, active), as numpy arrays."""
    N, L, K, P, B, tlen, err = WALK_TILE
    tile, _specs = tile_inputs(7, B, K, L, tlen, err)
    for k, (st, inp) in enumerate(jax_arm_steps(tile, N, L, P)):
        if k == 3:
            return st, tuple(np.array(x) for x in inp[:4])
    raise AssertionError("the tile has fewer than four arm steps")


def walk_inputs(case):
    """(bp, pred_rows, arm_len, mode, max_row, active) of one arm step
    for the walk, from the JAX DP (device_full._dp, as the JAX tile
    program runs it) as _arm_step_batch feeds it.  Rows of bp above a
    window's effective n_nodes hold random bytes: the DP writes none of
    them (every row of a window not active), so no walk may read them.

    NW / LOV / ROV: every window in that mode.  inactive: 40% of the
    windows with a graph have no arm this round.  empty_graph: a third
    of the windows have n_nodes == 0.  row0_run: NW with four random
    bases before each arm, so walks end with a horizontal run on row
    0."""
    N, L, _K, P, B, _tlen, _err = WALK_TILE
    st, (arm, arm_len, mode, active) = _walk_step()
    rng = np.random.default_rng(WALK_CASES.index(case))
    n_nodes = np.array(st.n_nodes)
    if case in ("NW", "LOV", "ROV", "row0_run"):
        mode[:] = {"NW": NW, "LOV": LOV, "ROV": ROV, "row0_run": NW}[case]
    if case == "inactive":
        active &= ~(rng.random(B) < 0.4)
    if case == "empty_graph":
        n_nodes[::3] = 0
        st = st._replace(n_nodes=jax.numpy.asarray(n_nodes))
    if case == "row0_run":
        arm = np.concatenate([rng.integers(0, 4, (B, 4)), arm],
                             axis=1)[:, :L].astype(np.int32)
        arm_len = np.where(arm_len > 0, np.minimum(arm_len + 4, L),
                           0).astype(np.int32)
    act = active & (arm_len > 0) & (n_nodes > 0)
    nn_eff = np.where(act, n_nodes, 0).astype(np.int32)
    ra = DF._rank_arrays_batch(st, N)
    bp, max_row = jax.vmap(functools.partial(DF._dp, N=N, L=L, P=P, **SC))(
        ra.node_code_r, ra.pred_rows, ra.pred_cnt_r, ra.is_end_r, nn_eff,
        arm, arm_len, mode)
    bp = np.array(bp)
    for b in range(B):
        bp[b, nn_eff[b] + 1:] = rng.integers(-128, 128,
                                             bp[b, nn_eff[b] + 1:].shape)
    return (bp, np.asarray(ra.pred_rows), arm_len, mode,
            np.asarray(max_row), act)


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def matched_from_exact(ti, tj, steps, active, L):
    """matched rebuilt from exact mode's emitter: each step that consumed
    query base j records its rank (or -1) at j; rows of windows not
    active are -1."""
    out = np.full((ti.shape[0], L), -1, np.int32)
    for b in np.nonzero(active)[0]:
        for t in range(int(steps[b])):
            if tj[b, t] >= 0:
                out[b, tj[b, t]] = ti[b, t]
    return out


@pytest.mark.parametrize("case", WALK_CASES)
def test_tile_walk_matches_jax(case):
    N, L, _K, P, B = WALK_TILE[:5]
    args = walk_inputs(case)
    bp, pr, al, md, mr, act = args
    want = np.asarray(DF._traceback_matched_batch(
        bp, pr, al, md, mr, active=act, N=N, L=L, P=P))
    got = tdp.poa_tb_matched_ref(*_torch(args), N=N, L=L, P=P)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
    assert np.array_equal(got.numpy(), want)
    assert (want[~act] == -1).all()
    assert 0 < act.sum() < B or case in ("NW", "LOV", "ROV", "row0_run")
    assert (want >= 0).any()
    if case == "row0_run":
        # some walk's last step is horizontal into (0, 0): row 0 reached
        # with bases left
        ti, tj, steps = (x.numpy() for x in tdp.poa_tb_batch_ref(
            *_torch((bp, pr, mr, al, md)), N=N, L=L, P=P))
        last = np.maximum(steps - 1, 0)
        tail = ((ti[np.arange(B), last] == -1)
                & (tj[np.arange(B), last] == 0) & act & (steps > 0))
        assert tail.any()


@pytest.mark.parametrize("case", WALK_CASES)
def test_tile_walk_is_exact_walk_rebuilt(case):
    """One walk serves both emitters: matched equals what exact mode's
    (ti, tj) on the same inputs record per query base."""
    N, L, _K, P, _B = WALK_TILE[:5]
    bp, pr, al, md, mr, act = walk_inputs(case)
    ti, tj, steps = (x.numpy() for x in tdp.poa_tb_batch_ref(
        *_torch((bp, pr, mr, al, md)), N=N, L=L, P=P))
    want = tdp.poa_tb_matched_ref(*_torch((bp, pr, al, md, mr, act)), N=N,
                                  L=L, P=P).numpy()
    assert np.array_equal(matched_from_exact(ti, tj, steps, act, L), want)


def test_tb_matched_wrapper_takes_plain_version_for_cpu_tensors():
    N, L, _K, P, _B = WALK_TILE[:5]
    targs = _torch(walk_inputs("inactive"))
    before = cuda_tb.poa_tb_matched.launches
    got = cuda_tb.poa_tb_matched(*targs, N=N, L=L, P=P)
    assert torch.equal(got, tdp.poa_tb_matched_ref(*targs, N=N, L=L, P=P))
    assert cuda_tb.poa_tb_matched.launches == before


def _matched_args(device, B=3, N=16, L=10, P=4):
    i = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device=device)
    bp = torch.zeros((B, N + 1, L + 1), dtype=torch.int8, device=device)
    return ((bp, i(B, N, P), i(B), i(B), i(B),
             torch.ones(B, dtype=torch.bool, device=device)),
            dict(N=N, L=L, P=P))


def test_tb_matched_wrapper_raises_for_a_device_without_kernel():
    args, kw = _matched_args(torch.device("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_tb.poa_tb_matched(*args, **kw)


def test_tb_matched_wrapper_rejects_bad_arguments():
    args, kw = _matched_args(torch.device("cpu"))
    for k, bad_arg, msg in (
            (0, args[0].to(torch.int16), "bp has dtype"),
            (1, args[1][:, :, :2], "pred_rows has shape"),
            (5, args[5].to(torch.int32), "active has dtype"),
            (4, args[4][:2], "max_row has shape")):
        bad = list(args)
        bad[k] = bad_arg
        with pytest.raises(ValueError, match=msg):
            cuda_tb.poa_tb_matched(*bad, **kw)


def card_walk_inputs(B, N, L, P, dev):
    """Tile-walk inputs at a tile class's shape on the card:
    test_torch_dp's multi-predecessor graphs (mixed modes, ragged
    n_nodes and arms) with a fifth of the windows not active (n_nodes 0,
    as the tile program gives them); kernel 1's bp and max_row, with bp
    rows above each window's n_nodes overwritten with random bytes."""
    rng = np.random.default_rng(N)
    nc, pr, pc, ie, nn, arm, al, md = multi_bucket(B, N, L, P, seed=N)
    nn[rng.random(B) < 0.2] = 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    bp, max_row = cuda_poa.poa_dp_batch(
        *(t(x) for x in (nc, pr, pc, ie, nn, arm, al, md)), N=N, L=L, P=P,
        **SC)
    junk = t(rng.integers(-128, 128, bp.shape, dtype=np.int8))
    rows = torch.arange(N + 1, device=dev)[None, :, None]
    bp = torch.where(rows > t(nn)[:, None, None], junk, bp)
    return bp, t(pr), t(al), t(md), max_row, t(nn > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 256, 126, 8), (256, 1024, 510, 8)],
                         ids=["class0", "class1"])
def test_tile_walk_kernel_matches_plain_on_card(cuda_device, shape):
    B, N, L, P = shape
    args = card_walk_inputs(B, N, L, P, cuda_device)
    before = cuda_tb.poa_tb_matched.launches
    got = cuda_tb.poa_tb_matched(*args, N=N, L=L, P=P)
    assert cuda_tb.poa_tb_matched.launches == before + 1
    want = tdp.poa_tb_matched_ref(*args, N=N, L=L, P=P)
    assert torch.equal(got.cpu(), want.cpu())
    assert (got[~args[5]] == -1).all() and (got >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_emitter_matches_plain_on_card(cuda_device, case):
    seed, B, N, L, P, (m, n, g), nseq, blen, rate = CASES[case]
    args, _rid = graph_bucket(seed, B, N, L, P, (m, n, g), nseq, blen, rate)
    targs = [torch.from_numpy(a).to(cuda_device) for a in args]
    bp, max_row = tdp.poa_dp_batch_ref(*targs, N=N, L=L, P=P, m=m, n=n,
                                       g=g)
    tb_args = (bp, targs[1], max_row, targs[6], targs[7])
    got = cuda_tb.poa_tb_batch(*tb_args, N=N, L=L, P=P)
    want = tdp.poa_tb_batch_ref(*tb_args, N=N, L=L, P=P)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu()), case


@pytest.mark.cuda
def test_tb_matched_wrapper_raises_on_cuda_tensors_it_cannot_take(
        cuda_device):
    args, kw = _matched_args(cuda_device)
    bad = list(args)
    bad[5] = bad[5].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_tb.poa_tb_matched(*bad, **kw)
