"""Kernels 4 and 5 of the tile program, the rank and the merge
(hypo_tpu_torch.poa.cuda_rank.rank_arrays, cuda_merge.merge_arm), held
to the JAX package's XLA code on the CPU: their wrappers, given CPU
tensors, run the plain versions (device_full._rank_arrays_batch, and
_merge_step: device_full._merge and the state selection), and every
leaf must equal hypo_tpu.poa.device_full._rank_arrays_batch and the
vmapped _merge (with _arm_step_batch's selection) on the same state.

States: the one before every arm step of tile_inputs tiles at both small
class shapes, of a tile whose windows overflow N (nodes and columns), of
a tile where a node with all P predecessor slots full gets a new edge,
and mid-run states with a third of the windows emptied (n_nodes == 0)
or half of them inactive; arm weights are 1-3.  The same states hold the
two facts that make kernel 4's counting equal to the sort (the valid
columns' positions are a permutation, col_node lists exactly the nodes
of each column), the one that makes kernel 5's targets unique (an
alignment visits a rank at most once, in increasing order) and the one
its column shifts rest on (the insertions' anchors are non-decreasing
in j).  Kernel 5's launch, from its source's launch header built with
g++, fits the card at every shape the runners launch.  Inputs
come from numpy seeds and every compared value is an integer:
tolerance 0.  Card-only cases carry the ``cuda`` marker.
"""
import functools
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu_torch import _build
from hypo_tpu_torch.poa import cuda_merge, cuda_rank
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.state import state_from_numpy, state_to_numpy
from hypo_tpu_torch.poa.full_runner import _CPU_TILE_B, CLASSES
from test_torch_device_full import SC, jax_arm_steps, tile_inputs

CPU = torch.device("cpu")
RANK_FIELDS = DF.RankArrays._fields


def crafted_tile(windows, L, K):
    """A tile of NW arms framed by J/O (codes 4/5), one pool row each:
    ``windows`` holds each window's list of (bases over ACGT, weight)."""
    B = len(windows)
    pool, plen = [], []
    idx = np.full((B, K), -1, np.int32)
    aw = np.zeros((B, K), np.int32)
    for b, arms in enumerate(windows):
        for k, (bases, w) in enumerate(arms):
            s = [4] + ["ACGT".index(c) for c in bases] + [5]
            row = np.zeros(L, np.int8)
            row[:len(s)] = s
            idx[b, k] = len(pool)
            aw[b, k] = w
            pool.append(row)
            plen.append(len(s))
    narms = np.array([len(a) for a in windows], np.int32)
    return (np.stack(pool), np.array(plen, np.int32), idx,
            np.zeros((B, K), np.int8), aw, narms, np.zeros(B, np.int32))


# P = 2: the third arm of window 0 puts a third base in the column of G
# and C, whose successor T already has two predecessors
SLOT_WINDOWS = [[("ACGTACGTAC", 1), ("ACCTACGTAC", 2), ("ACATACGTAC", 1),
                 ("ACTTACGTAC", 3)],
                [("ACGTACGTAC", 2), ("ACGTACGTAC", 3), ("ACGAACGTAC", 1)],
                [("GATTACAGAT", 1), ("GATCACAGAT", 1), ("GATTACAG", 2)]]


# N = 64: window 0's arms insert columns until both its nodes and its
# columns would pass N (a column holds one node or more, so columns never
# pass N alone), window 1's random arms pass N in nodes only, window 2
# fits and has one arm more than the others
_rng = np.random.default_rng(8)
WILD_WINDOWS = [[("A" * 10, 1), ("C" * 40, 2), ("G" * 70, 1)],
                [("".join(_rng.choice(list("ACGT"), 40)), w)
                 for w in (1, 3, 1)],
                [("ACGTACGTAC", 1), ("ACGTTCGTAC", 2), ("ACGTACGAC", 1),
                 ("ACGTACGTAC", 3)]]


def _fresh_rows(st, rows):
    """``st`` (JAX, batched) with windows ``rows`` set to a fresh state."""
    B = st.n_nodes.shape[0]
    N, P = st.pred_nd.shape[1:]
    fresh = DF._bcast_state(N, P, B)
    mask = np.zeros(B, bool)
    mask[rows] = True

    def pick(old, new):
        keep = mask.reshape((B,) + (1,) * (old.ndim - 1))
        return jnp.asarray(np.where(keep, np.asarray(new), np.asarray(old)))

    return jax.tree_util.tree_map(pick, st, fresh)


# name: (N, L, P, how the states are made)
CASES = {
    "class0_small": (80, 40, 8, "tile"),
    "class1_small": (200, 100, 8, "tile"),
    "node_col_overflow": (64, 80, 8, "wild"),
    "slot_overflow": (48, 16, 2, "slots"),
    "empty_graphs": (80, 40, 8, "empty"),
    "inactive": (80, 40, 8, "inactive"),
}


@functools.lru_cache(maxsize=None)
def case_steps(case):
    """[(JAX state before the step, (arm, arm_len, mode, active, w)), ...]
    of every arm step of the case, and the final state with None."""
    N, L, P, how = CASES[case]
    if how == "tile":
        tile, _ = tile_inputs(5, (12, 6)[N > 100], (6, 5)[N > 100], L,
                              (30, 80)[N > 100], 0.12, n_wild=1)
    elif how == "wild":
        tile = crafted_tile(WILD_WINDOWS, L, 4)
    elif how == "slots":
        tile = crafted_tile(SLOT_WINDOWS, L, 4)
    else:
        tile, _ = tile_inputs(9, 12, 6, L, 30, 0.12)
    steps = [(st, None if inp is None else tuple(np.array(x) for x in inp))
             for st, inp in jax_arm_steps(tile, N, L, P)]
    if how in ("empty", "inactive"):
        st, inp = steps[2]
        if how == "empty":
            st = _fresh_rows(st, np.arange(0, len(inp[1]), 3))
        else:
            inp[3][::2] = False
        steps = [(st, inp)]
    return steps


@functools.lru_cache(maxsize=None)
def _jax_fns(N, L, P):
    """(the step's rank arrays and matched [B, L] before the empty-graph
    rule, as hypo_tpu's _arm_step_batch computes them; its vmapped
    _merge), jitted."""
    def walk(st, arm, arm_len, mode, active):
        ra = DF._rank_arrays_batch(st, N)
        act = active & (arm_len > 0) & (st.n_nodes > 0)
        bp, max_row = jax.vmap(functools.partial(DF._dp, N=N, L=L, P=P,
                                                 **SC))(
            ra.node_code_r, ra.pred_rows, ra.pred_cnt_r, ra.is_end_r,
            jnp.where(act, st.n_nodes, 0), arm, arm_len, mode)
        return ra, DF._traceback_matched_batch(
            bp, ra.pred_rows, arm_len, mode, max_row, active=act, N=N, L=L,
            P=P)

    merge = jax.vmap(functools.partial(DF._merge, N=N, L=L, P=P))
    return jax.jit(walk), jax.jit(merge)


def _t(x, dtype=torch.int32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def merge_cases(case):
    """Per arm step: (JAX state, step inputs, JAX rank arrays, matched)."""
    N, L, P, _how = CASES[case]
    walk, _merge = _jax_fns(N, L, P)
    for st, inp in case_steps(case):
        if inp is not None:
            ra, matched = walk(st, *inp[:4])
            yield st, inp, ra, np.asarray(matched)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_matches_jax_leaf_by_leaf(case):
    """rank_arrays (all leaves, and the arm step's and the finish's
    subsets, the rest None) equals hypo_tpu's _rank_arrays_batch."""
    N = CASES[case][0]
    jrank = jax.jit(functools.partial(DF._rank_arrays_batch, N=N))
    before = cuda_rank.rank_arrays.launches
    for st, _inp in case_steps(case):
        want = jrank(st)
        st_t = state_from_numpy(st, CPU)
        for leaves in (cuda_rank.FIELDS, cuda_rank.STEP_LEAVES,
                       cuda_rank.CONS_LEAVES):
            got = cuda_rank.rank_arrays(st_t, N, leaves)
            for f in RANK_FIELDS:
                g = getattr(got, f)
                if f not in leaves:
                    assert g is None, f
                    continue
                w = np.asarray(getattr(want, f))
                assert g.dtype == (torch.bool if f == "is_end_r"
                                   else torch.int32), f
                assert np.array_equal(g.numpy(), w), (f, leaves)
    assert cuda_rank.rank_arrays.launches == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matches_jax_leaf_by_leaf(case):
    """merge_arm updates the state in place to hypo_tpu's arm step's
    result (its vmapped _merge, the empty-graph rule, the selection and
    the sticky ovf), and the port's _merge equals the vmapped _merge
    before the selection."""
    N, L, P, how = CASES[case]
    _walk, jmerge = _jax_fns(N, L, P)
    jstep = jax.jit(functools.partial(DF._arm_step_batch, N=N, L=L, P=P,
                                      dp_impl="xla", **SC))
    seen = dict(overflow=0, applied=0, weights=set(), empty=0, idle=0)
    before = cuda_merge.merge_arm.launches
    for st, inp, ra, matched in merge_cases(case):
        arm, arm_len, mode, active, w = inp
        want = jstep(st, *inp)
        st_t = state_from_numpy(st, CPU)
        args = (_t(ra.node_col_r), _t(matched), _t(arm), _t(arm_len),
                _t(w), _t(active, torch.bool))
        out = cuda_merge.merge_arm(st_t, *args, N=N, L=L, P=P)
        assert out is st_t
        got = state_to_numpy(out)
        for f in DF.PoaState._fields:
            assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
        # the merge alone, before the selection
        nn = np.asarray(st.n_nodes)
        m_e = np.where((nn == 0)[:, None], -1, matched)
        jst, jovf = jmerge(st, ra.order, ra.node_col_r, m_e, arm, arm_len, w)
        tst, tovf = TF._merge(state_from_numpy(st, CPU), args[0], _t(m_e),
                              *args[2:5], N=N, L=L, P=P)
        assert np.array_equal(tovf.numpy(), np.asarray(jovf))
        for f, a in state_to_numpy(tst).items():
            assert np.array_equal(a, np.asarray(getattr(jst, f))), f
        live = active & (arm_len > 0) & ~np.asarray(st.ovf)
        seen["overflow"] += int((live & np.asarray(jovf)).sum())
        seen["applied"] += int((live & ~np.asarray(jovf)).sum())
        seen["weights"] |= set(w[live].tolist())
        seen["empty"] += int((live & (nn == 0)).sum())
        seen["idle"] += int((~active).sum())
    assert cuda_merge.merge_arm.launches == before
    assert seen["applied"] > 0
    assert seen["empty"] > 0 or how == "inactive"
    assert (seen["overflow"] > 0) == (how in ("tile", "wild", "slots"))
    assert seen["idle"] > 0 or how == "empty"
    assert max(seen["weights"]) >= 2


def _overflow_kinds(case):
    """For each window that overflows in the case: 'nodes', 'cols' or
    'slot' (only a new edge past P predecessors)."""
    N, L, P, _how = CASES[case]
    _walk, jmerge = _jax_fns(N, L, P)
    kinds = set()
    for st, inp, ra, matched in merge_cases(case):
        arm, arm_len, _mode, active, w = inp
        nn = np.asarray(st.n_nodes)
        m_e = np.where((nn == 0)[:, None], -1, matched)
        jst, jovf = jmerge(st, ra.order, ra.node_col_r, m_e, arm, arm_len, w)
        live = active & (arm_len > 0) & ~np.asarray(st.ovf) & np.asarray(jovf)
        for b in np.nonzero(live)[0]:
            if int(jst.n_nodes[b]) > N:
                kinds.add("nodes")
            if int(jst.n_cols[b]) > N:
                kinds.add("cols")
            if int(jst.n_nodes[b]) <= N and int(jst.n_cols[b]) <= N:
                kinds.add("slot")
    return kinds


def test_overflow_cases_reach_each_cap():
    assert {"nodes", "cols"} <= _overflow_kinds("node_col_overflow")
    assert _overflow_kinds("slot_overflow") == {"slot"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_states_hold_what_the_kernels_rely_on(case):
    """Per window of every state: the positions of the n_cols valid
    columns are a permutation of 0..n_cols-1; col_node[c] lists exactly
    the valid nodes whose node_col is c, each under its code, and nothing
    past n_cols; every alignment (matched) visits increasing ranks."""
    N = CASES[case][0]
    for st, inp in case_steps(case):
        s = {f: np.asarray(getattr(st, f)) for f in DF.PoaState._fields}
        for b in range(len(s["n_nodes"])):
            nn, nc = int(s["n_nodes"][b]), int(s["n_cols"][b])
            assert sorted(s["col_pos"][b, :nc]) == list(range(nc)), b
            cn = s["col_node"][b]
            assert (cn[nc:] == -1).all()
            listed = sorted((int(c), int(v)) for c, k in zip(*np.nonzero(
                cn[:nc] >= 0)) for v in [cn[c, k]])
            owned = sorted((int(s["node_col"][b, v]), v) for v in range(nn))
            assert listed == owned, b
            for c, k in zip(*np.nonzero(cn[:nc] >= 0)):
                assert s["node_code"][b, cn[c, k]] == k
        assert (s["n_nodes"] <= N).all() and (s["n_cols"] <= N).all()
    for st, inp, ra, matched in merge_cases(case):
        for row in matched:
            hit = row[row >= 0]
            assert (np.diff(hit) > 0).all()
        for anchors in merge_anchors(st, inp, ra, matched):
            assert (np.diff(anchors) >= 0).all()


def merge_anchors(st, inp, ra, matched):
    """Per window: the anchor of each inserted base in order of j (the
    running maximum of the matched bases' column positions, -1 before
    the first), as _merge computes it; matched positions strictly rise."""
    arm_len = inp[1]
    nn = np.asarray(st.n_nodes)
    col_pos = np.asarray(st.col_pos)
    ncr = np.asarray(ra.node_col_r)
    for b, row in enumerate(matched):
        m = row[:max(int(arm_len[b]), 0)] if nn[b] > 0 else []
        pos = [int(col_pos[b, ncr[b, r]]) for r in m if r >= 0]
        assert (np.diff(pos) > 0).all()
        last, anchors = -1, []
        for r in m:
            if r >= 0:
                last = max(last, int(col_pos[b, ncr[b, r]]))
            else:
                anchors.append(last)
        if nn[b] == 0:
            anchors = [-1] * max(int(arm_len[b]), 0)
        yield np.array(anchors, np.int64)


# (N, L, B) of every merge the runners launch: each class at its tile and
# split over two device blocks, and the CPU tile (B = 64) over 1, 2 and 8
# devices
RUNNER_SHAPES = sorted({(N, L, B) for L, N, _K, tile_b, _A in CLASSES
                        for B in (tile_b, tile_b // 2)}
                       | {(N, L, _CPU_TILE_B // nd) for L, N, *_ in CLASSES
                          for nd in (1, 2, 8)})


LAUNCH_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include "poa_merge_launch.h"
int main(int argc, char** argv) {
  for (int i = 1; i + 2 < argc; i += 3) {
    const int N = atoi(argv[i]), L = atoi(argv[i + 1]), B = atoi(argv[i + 2]);
    const merge_launch::Shape s = merge_launch::merge_shape(N, L);
    printf("%d %d %d %d %lld %d %d\n", s.per, s.warps, s.windows,
           merge_launch::threads(s), merge_launch::smem_bytes(s, N, L),
           merge_launch::shape_ok(s, N, L), merge_launch::blocks(s, B));
  }
}
"""


@pytest.fixture(scope="module")
def merge_launch(tmp_path_factory):
    """(N, L, B) -> the launch kernel 5's source makes there (per, warps,
    windows, threads, shared bytes, taken, blocks): its launch header,
    csrc/poa_merge_launch.h, built with g++ (no CUDA in it)."""
    d = tmp_path_factory.mktemp("merge_launch")
    (d / "main.cpp").write_text(LAUNCH_MAIN)
    subprocess.run(["g++", "-std=c++17", f"-I{_build.SRC_DIR}",
                    str(d / "main.cpp"), "-o", str(d / "launch")],
                   check=True, capture_output=True, timeout=120)

    def launch(N, L, B):
        out = subprocess.run([str(d / "launch"), str(N), str(L), str(B)],
                             check=True, capture_output=True, text=True)
        return tuple(int(x) for x in out.stdout.split())

    return launch


@pytest.mark.parametrize("shape", RUNNER_SHAPES,
                         ids=[f"N{n}_L{l}_B{b}" for n, l, b in RUNNER_SHAPES])
def test_merge_launch_shape_fits_the_card(merge_launch, shape):
    """Kernel 5's launch, as its source picks it, at every shape the
    runners launch: taken by the kernel, warps covering the arm, at most
    512 threads a block (the kernel's launch bound, within the card's
    1024), at most 48 KB of shared memory (the wrapper sets no opt-in),
    and blocks enough for B windows, the last one not empty."""
    N, L, B = shape
    per, warps, windows, threads, smem, ok, blocks = merge_launch(N, L, B)
    assert ok
    assert per * 32 * warps >= L
    assert threads <= 512 <= 1024
    assert smem <= 48 * 1024
    assert (blocks - 1) * windows < B <= blocks * windows


@pytest.mark.parametrize("N, L", [(1024, 513), (6532, 512), (256, 0)])
def test_merge_launch_refuses_what_the_kernel_cannot_hold(merge_launch, N,
                                                          L):
    """Past L = 512 (16 warps of a base a lane) or 48 KB of shared memory
    for one window, or with no arm, the source takes no launch (and
    hypo_poa_merge returns cudaErrorInvalidValue); just inside both
    limits it does."""
    assert not merge_launch(N, L, 1)[5]
    assert merge_launch(min(N, 6528), min(max(L, 1), 512), 1)[5]


def test_wrappers_check_their_arguments():
    N, P, B, L = 16, 4, 3, 10
    st = TF.init_state(N, P, B, CPU)
    with pytest.raises(ValueError, match="no leaf"):
        cuda_rank.rank_arrays(st, N, ("order", "nodes_r"))
    with pytest.raises(ValueError, match="col_pos has dtype"):
        cuda_rank.rank_arrays(st._replace(col_pos=st.col_pos.long()), N)
    with pytest.raises(ValueError, match="col_node has shape"):
        cuda_rank.rank_arrays(st._replace(col_node=st.col_node[:, :, :4]), N)
    i = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    ok = (i(B, N), i(B, L), i(B, L), i(B), i(B),
          torch.ones(B, dtype=torch.bool))
    kw = dict(N=N, L=L, P=P)
    for k, bad, msg in ((0, i(B, N + 1), "node_col_r has shape"),
                        (1, i(B, 2 * L)[:, ::2], "matched is not contiguous"),
                        (3, i(B).long(), "arm_len has dtype"),
                        (5, i(B), "active has dtype")):
        args = list(ok)
        args[k] = bad
        with pytest.raises(ValueError, match=msg):
            cuda_merge.merge_arm(st, *args, **kw)
    with pytest.raises(ValueError, match="ovf has dtype"):
        cuda_merge.merge_arm(st._replace(ovf=i(B)), *ok, **kw)
    merged = cuda_merge.merge_arm(st, *ok, **kw)
    assert merged is st and int(st.n_nodes.sum()) == 0   # nothing active


def test_wrappers_raise_for_a_device_without_kernel():
    N, P, B, L = 16, 4, 3, 10
    meta = torch.device("meta")
    st = TF.init_state(N, P, B, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_rank.rank_arrays(st, N)
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=meta)  # noqa
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_merge.merge_arm(st, i(B, N), i(B, L), i(B, L), i(B), i(B),
                             torch.ones(B, dtype=torch.bool, device=meta),
                             N=N, L=L, P=P)


@pytest.mark.parametrize("name", ["poa_rank", "poa_merge"])
def test_a_failed_build_raises(name, tmp_path, monkeypatch):
    """A kernel whose nvcc build fails raises with the compiler's output
    and loads nothing: the wrappers have no fallback to take."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load(name)
    assert name not in _build._libs
    assert not list(tmp_path.glob("*.so"))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _record_steps(tile, dev, N, L, P, monkeypatch):
    """run_arm_steps on the card, recording before every merge a clone of
    the state and the merge's other inputs."""
    calls = []
    merge = TF.merge_arm

    def record(st, *args, **kw):
        calls.append((TF.PoaState(*(x.clone() for x in st)),
                      *(a.clone() for a in args)))
        return merge(st, *args, **kw)

    monkeypatch.setattr(TF, "merge_arm", record)
    final = TF.run_arm_steps(*tile[:6], N=N, L=L, P=P, device=dev, **SC)
    return calls, final


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 256, 126, 100), (256, 1024, 510,
                                                             400)],
                         ids=["class0", "class1"])
def test_kernels_match_plain_on_card(cuda_device, shape, monkeypatch):
    """Kernels 4 and 5 against their plain versions, every leaf, on the
    state before every arm step of a real tile at a class's full shape."""
    B, N, L, tlen = shape
    P = 8
    tile, _ = tile_inputs(3, B, 16, L, tlen, 0.04, n_wild=2)
    calls, final = _record_steps(tile, cuda_device, N, L, P, monkeypatch)
    for st, ncr, matched, arm, al, w, active in calls + [(final,) + (None,)
                                                         * 6]:
        want = TF._rank_arrays_batch(st, N)
        got = cuda_rank.rank_arrays(st, N)
        for f, a, b in zip(RANK_FIELDS, got, want):
            assert torch.equal(a, b), f
        if ncr is None:
            continue
        want = TF._merge_step(st, ncr, matched, arm, al, w, active, N=N,
                              L=L, P=P)
        got = cuda_merge.merge_arm(TF.PoaState(*(x.clone() for x in st)),
                                   ncr, matched, arm, al, w, active, N=N,
                                   L=L, P=P)
        for f, a, b in zip(TF.PoaState._fields, got, want):
            assert torch.equal(a, b), f
    assert int(final.ovf.sum()) >= 2


@pytest.mark.cuda
def test_captured_step_counts_rank_and_merge_at_each_replay(cuda_device):
    """A tile through the tile program: the capture's eager call of each
    part counts one launch, each replayed step one kernel-4 launch (the
    step head, which ranks) and one merge, each finish one rank; the
    tile equals the eager tile."""
    from test_torch_device_full import class_kw, consecutive_tiles
    kw = class_kw(0)
    counters = (cuda_rank.rank_arrays, cuda_rank.step_head,
                cuda_merge.merge_arm)
    for c in counters:
        c.launches = 0
    prog = TF.build_tile_program(**kw, devices=cuda_device)
    tiles = consecutive_tiles(0)
    outs = [prog(*t) for t in tiles]
    torch.cuda.synchronize()
    steps = sum(int(t[5].max()) for t in tiles)
    assert cuda_merge.merge_arm.launches == 1 + steps
    assert cuda_rank.step_head.launches == 1 + steps
    assert cuda_rank.rank_arrays.launches == 1 + len(tiles)
    eager_kw = {k: kw[k] for k in ("N", "L", "P", "m", "n", "g")}
    for t, out in zip(tiles, outs):
        assert torch.equal(out, TF.run_tile_eager(*t, **eager_kw,
                                                  device=cuda_device))


@pytest.mark.cuda
def test_wrappers_raise_when_the_kernel_cannot_load(cuda_device,
                                                    monkeypatch):
    def broken(name, src=None):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", broken)
    N, P, B, L = 16, 4, 3, 10
    st = TF.init_state(N, P, B, cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed for poa_rank"):
        cuda_rank.rank_arrays(st, N)
    i = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed for poa_merge"):
        cuda_merge.merge_arm(st, i(B, N), i(B, L), i(B, L), i(B), i(B),
                             torch.ones(B, dtype=torch.bool,
                                        device=cuda_device), N=N, L=L, P=P)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_kernel_matches_plain_on_crafted_cases_on_card(cuda_device,
                                                             case):
    """Kernel 5 against _merge_step, every leaf, at every arm step of the
    crafted cases: both overflow kinds, empty graphs, inactive windows
    and windows that overflowed at an earlier step."""
    N, L, P, _how = CASES[case]
    before = cuda_merge.merge_arm.launches
    steps = 0
    for st, inp, ra, matched in merge_cases(case):
        arm, arm_len, _mode, active, w = inp
        st_t = state_from_numpy(st, cuda_device)
        args = tuple(_t(x).to(cuda_device) for x in (
            ra.node_col_r, matched, arm, arm_len, w)) + (
            _t(active, torch.bool).to(cuda_device),)
        want = TF._merge_step(st_t, *args, N=N, L=L, P=P)
        got = cuda_merge.merge_arm(TF.clone_state(st_t), *args, N=N, L=L,
                                   P=P)
        for f, a, b in zip(TF.PoaState._fields, got, want):
            assert torch.equal(a, b), (f, steps)
        steps += 1
    assert cuda_merge.merge_arm.launches == before + steps


@functools.lru_cache(maxsize=None)
def _card_rows(ci):
    """(the merge's inputs before every arm step of a small tile at class
    ``ci``'s N and L on the card, N, L): the rows mixed batches draw
    from."""
    L, N, _K, _B, _A = CLASSES[ci]
    tile, _ = tile_inputs(3, (48, 12)[ci], (6, 4)[ci], L, (100, 400)[ci],
                          0.04, n_wild=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    calls = []
    merge = TF.merge_arm

    def record(st, *args, **kw):
        calls.append((TF.clone_state(st), tuple(a.clone() for a in args)))
        return merge(st, *args, **kw)

    TF.merge_arm = record
    try:
        TF.run_arm_steps(*tile[:6], N=N, L=L, P=8, device=dev, **SC)
    finally:
        TF.merge_arm = merge
    return calls, N, L


def mixed_batch(ci, B, first):
    """B windows drawn from _card_rows(ci): window i merges, skips or
    overflows by (i + first) % 3.  A skip is a merging row made inactive,
    given no arm, or marked overflowed at an earlier step; an overflow
    is a row that creates a node or a column with n_nodes or n_cols set
    to N."""
    calls, N, L = _card_rows(ci)
    P = 8
    rows = {"node": [], "col": []}
    for k, (st, args) in enumerate(calls):
        after = TF._merge_step(st, *args, N=N, L=L, P=P)
        live = args[5] & (args[3] > 0) & ~st.ovf & ~after.ovf
        for b in torch.nonzero(live).flatten().tolist():
            if after.n_nodes[b] > st.n_nodes[b]:
                rows["node"].append((k, b))
            if after.n_cols[b] > st.n_cols[b]:
                rows["col"].append((k, b))
    rng = np.random.default_rng(B + first)
    pick = [rows[("node", "col")[i % 2]] for i in range(B)]
    src = [p[rng.integers(len(p))] for p in pick]
    st = TF.PoaState(*(torch.stack([getattr(calls[k][0], f)[b]
                                    for k, b in src])
                       for f in TF.PoaState._fields))
    args = [torch.stack([calls[k][1][a][b] for k, b in src])
            for a in range(6)]
    for i in range(B):
        kind = (i + first) % 3
        if kind == 1:
            how = (i // 3) % 3
            if how == 0:
                args[5][i] = False
            elif how == 1:
                args[3][i] = 0
            else:
                st.ovf[i] = True
        elif kind == 2:
            field = st.n_nodes if i % 2 == 0 else st.n_cols
            field[i] = N
    return st, tuple(args), N, L, P


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 2049])
@pytest.mark.parametrize("ci", [0, 1])
def test_merge_kernel_on_ragged_mixed_batches_on_card(cuda_device, ci, B):
    """Batches of 1, 7 and 2049 windows, none a multiple of the launch's
    windows a block, each window merging, skipping or overflowing by
    turns (a block of 4 one-warp windows at class 0 holds all three):
    kernel 5 equals _merge_step on every leaf.  B = 1 runs each kind."""
    seen = [0, 0, 0]
    firsts = (0, 1, 2) if B == 1 else (0,)
    for first in firsts:
        st, args, N, L, P = mixed_batch(ci, B, first)
        want = TF._merge_step(st, *args, N=N, L=L, P=P)
        got = cuda_merge.merge_arm(TF.clone_state(st), *args, N=N, L=L,
                                   P=P)
        for f, a, b in zip(TF.PoaState._fields, got, want):
            assert torch.equal(a, b), f
        live = args[5] & (args[3] > 0) & ~st.ovf
        seen[0] += int((live & ~want.ovf).sum())
        seen[1] += int((~live).sum())
        seen[2] += int((live & want.ovf).sum())
    assert seen == [sum((i + f) % 3 == k for i in range(B) for f in firsts)
                    for k in range(3)]
    windows = cuda_merge.launch_shape(N, L).windows
    assert windows == 1 or B % windows
