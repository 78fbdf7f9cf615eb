"""Exact mode's device call: the port's DP + traceback
(hypo_tpu_torch.poa.dp.poa_dp_tb_batch_ref, and poa.cuda_tb, whose
wrappers take the plain versions for CPU tensors) against
hypo_tpu.poa.jax_poa.poa_dp_tb_batch, on graphs that hypo_tpu.poa.Graph
builds from mutated random sequences.  Inputs come from numpy seeds;
every compared value is an integer, so the tolerance is 0, over all
S = N + L + 1 traceback entries."""
import numpy as np
import pytest
import torch

from hypo_tpu.poa import LOV, NW, ROV, Graph, PoaAligner, jax_poa
from hypo_tpu_torch.poa import cuda_tb
from hypo_tpu_torch.poa import dp as tdp

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
