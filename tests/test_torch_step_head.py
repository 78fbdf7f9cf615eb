"""The tile program's step head (hypo_tpu_torch.poa.cuda_rank.step_head:
step k's arm fetch and kernel 4's rank in one launch) and kernel 4's
launch (csrc/poa_rank_launch.h).

On the CPU the wrapper runs its plain version
(device_full._step_head_batch), which must give what the JAX package's
tile body fetches for step k (hypo_tpu/poa/device_full.py:756-765: rows,
active, arm, arm length, mode, weight), the act and nn_eff of its
_arm_step_batch (:444-445) and its _rank_arrays_batch, and what the
port's own step computed before the head existed (the torch ops of
_Block.step and _arm_step_batch), on ragged tiles of both classes:
windows with no arm (narms 0), a -1 in mid-row, rows set past narms, and
steps past every window's arms.  Kernel 4's launch, from its source's
launch header built with g++, fits the card at every shape the runners
launch.  Inputs come from numpy seeds and every compared value is an
integer: tolerance 0.  Card-only cases (``cuda`` marker) hold the head
and kernel 4 to their plain versions at both classes, at B = 1, 7 and
2049, at N not a multiple of a window's threads, and on the generic
path (N not a multiple of 4, P other than 8, unaligned arrays).
"""
import functools
import subprocess

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu_torch import _build
from hypo_tpu_torch.poa import cuda_rank
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa.cuda_rank import FIELDS, STEP_LEAVES
from hypo_tpu_torch.poa.full_runner import _CPU_TILE_B, CLASSES
from hypo_tpu_torch.state import state_from_numpy
from test_torch_device_full import SC, jax_arm_steps, ragged, tile_inputs

CPU = torch.device("cpu")
HEAD_FIELDS = TF.StepHead._fields[:-1]


# class shapes at a few windows on the CPU: (L, N, B, arms, arm length)
CPU_CASES = {"class0": (126, 256, 24, 6, 100),
             "class1": (510, 1024, 10, 4, 300)}


@functools.lru_cache(maxsize=None)
def cpu_case(case):
    """(ragged tile, the JAX states before each of its arm steps and the
    final one, N, L) of a CPU case."""
    L, N, B, arms, tlen = CPU_CASES[case]
    tile, _ = tile_inputs(17, B, arms, L, tlen, 0.1)
    tile = ragged(tile)
    states = [st for st, _inp in jax_arm_steps(tile, N, L, 8)]
    return tile, states, N, L


def tensors(tile, device=CPU):
    """The head's tile inputs as the tile program's buffers hold them."""
    pool, plen, idx, amode, aw, narms = tile[:6]
    dt = (np.int8, np.int32, np.int32, np.int8, np.int32, np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, d)).to(device)
                 for x, d in zip((pool, plen, idx, amode, aw, narms), dt))


def jax_fetch(tile, st, k):
    """hypo_tpu's tile body at step k (device_full.py:756-765), in numpy,
    with its _arm_step_batch's act and nn_eff (:444-445)."""
    pool, plen, idx, amode, aw, narms = tile[:6]
    rows = idx[:, k]
    active = (k < narms) & (rows >= 0)
    rr = np.maximum(rows, 0)
    al = np.where(active, plen[rr], 0)
    nn = np.asarray(st.n_nodes)
    act = active & (al > 0) & (nn > 0)
    return dict(arm=pool[rr].astype(np.int32), arm_len=al,
                mode=amode[:, k].astype(np.int32), w=aw[:, k],
                active=active, act=act, nn_eff=np.where(act, nn, 0))


def old_step_ops(st, pool, plen, idx, amode, aw, narms, k, N):
    """The torch ops of _Block.step and _arm_step_batch before the step
    head, then the arm step's rank arrays."""
    col = k.long().expand(idx.shape[0], 1)
    rows = idx.gather(1, col)[:, 0]
    active = (k < narms) & (rows >= 0)
    rr = rows.clamp(min=0).long()
    al = torch.where(active, plen[rr], 0)
    act = active & (al > 0) & (st.n_nodes > 0)
    return dict(arm=pool[rr].to(torch.int32), arm_len=al,
                mode=amode.gather(1, col)[:, 0].to(torch.int32),
                w=aw.gather(1, col)[:, 0], active=active, act=act,
                nn_eff=torch.where(act, st.n_nodes, 0),
                ra=cuda_rank.rank_arrays(st, N, STEP_LEAVES))


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_step_head_plain_matches_jax_and_the_old_step(case):
    """_step_head_batch at every step of a ragged tile and two steps past
    its last: the fetch equals hypo_tpu's tile body's, every rank leaf
    its _rank_arrays_batch, and all of it the port's step before the
    head (the same dtypes)."""
    tile, states, N, L = cpu_case(case)
    jrank = jax.jit(functools.partial(DF._rank_arrays_batch, N=N))
    t = tensors(tile)
    kmax = len(states) - 1
    seen = dict(none=0, hole=0, past=0, active=0)
    for k in range(min(kmax + 2, tile[2].shape[1])):
        st = states[min(k, kmax)]
        st_t = state_from_numpy(st, CPU)
        kt = torch.tensor([k], dtype=torch.int32)
        got = TF._step_head_batch(st_t, *t, kt, N=N)
        want = jax_fetch(tile, st, k)
        old = old_step_ops(st_t, *t, kt, N)
        for f in HEAD_FIELDS:
            g = getattr(got, f)
            assert g.dtype == old[f].dtype and torch.equal(g, old[f]), f
            assert np.array_equal(g.numpy(), want[f]), (f, k)
        ra = jrank(st)
        for f in FIELDS:
            assert np.array_equal(getattr(got.ra, f).numpy(),
                                  np.asarray(getattr(ra, f))), f
        for f in STEP_LEAVES:
            assert torch.equal(getattr(got.ra, f), getattr(old["ra"], f)), f
        idx, narms = tile[2], tile[5]
        seen["none"] += int((narms == 0).sum())
        seen["hole"] += int(((idx[:, k] < 0) & (k < narms)).sum())
        seen["past"] += int(((idx[:, k] >= 0) & (k >= narms)).sum())
        seen["active"] += int(want["act"].sum())
    assert min(seen.values()) > 0, seen


def test_step_head_fills_its_buffers_on_the_cpu():
    """The wrapper, given CPU tensors, writes the plain head into the
    buffers it is given (the rank leaves of STEP_LEAVES only), returns
    them, leaves k as it was and counts no launch."""
    tile, states, N, L = cpu_case("class0")
    st = state_from_numpy(states[2], CPU)
    B = st.n_nodes.shape[0]
    out = TF.head_buffers(B, N, L, 8, CPU)
    k = torch.tensor([2], dtype=torch.int32)
    before = cuda_rank.step_head.launches
    got = cuda_rank.step_head(st, *tensors(tile), k, out, N=N)
    assert got is out and int(k) == 2
    assert cuda_rank.step_head.launches == before
    want = TF._step_head_batch(st, *tensors(tile), k, N=N)
    for f in HEAD_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in FIELDS:
        g = getattr(got.ra, f)
        if f in STEP_LEAVES:
            assert torch.equal(g, getattr(want.ra, f)), f
        else:
            assert g is None, f


def _bad(what):
    """(the head's arguments with one made wrong as ``what`` says, the
    error it must raise)."""
    N, P, B, L, K, A = 16, 4, 3, 10, 5, 7
    st = TF.init_state(N, P, B, CPU)
    i = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    b = lambda *s: torch.zeros(s, dtype=torch.int8)  # noqa: E731
    args = dict(pool=b(A, L), plen=i(A), idx=i(B, K), amode=b(B, K),
                aw=i(B, K), narms=i(B), k=i(1))
    out = TF.head_buffers(B, N, L, P, CPU)
    msg = {"pool": "pool has dtype", "k": "k has shape",
           "amode": "amode is not contiguous", "arm": "arm has shape",
           "act": "act has dtype", "pred_rows": "pred_rows has shape"}[what]
    if what == "pool":
        args["pool"] = i(A, L)
    elif what == "k":
        args["k"] = i(2)
    elif what == "amode":
        args["amode"] = b(B, 2 * K)[:, ::2]
    elif what == "arm":
        out = out._replace(arm=i(B, L + 1))
    elif what == "act":
        out = out._replace(act=i(B))
    else:
        out = out._replace(ra=out.ra._replace(pred_rows=i(B, N, P + 1)))
    return st, args, out, N, msg


@pytest.mark.parametrize("what", ["pool", "k", "amode", "arm", "act",
                                  "pred_rows"])
def test_step_head_checks_its_arguments(what):
    st, args, out, N, msg = _bad(what)
    with pytest.raises(ValueError, match=msg):
        cuda_rank.step_head(st, *args.values(), out, N=N)


def test_step_head_raises_for_a_device_without_kernel():
    N, P, B, L, K, A = 16, 4, 3, 10, 5, 7
    meta = torch.device("meta")
    st = TF.init_state(N, P, B, meta)
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=meta)  # noqa
    b = lambda *s: torch.zeros(s, dtype=torch.int8, device=meta)  # noqa
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_rank.step_head(st, b(A, L), i(A), i(B, K), b(B, K), i(B, K),
                            i(B), i(1), TF.head_buffers(B, N, L, P, meta),
                            N=N)


# (B, N) of every rank the runners launch: each class at its tile and
# split over two device blocks, and the CPU tile (B = 64) over 1, 2 and 8
# devices
RUNNER_SHAPES = sorted({(B, N) for _L, N, _K, tile_b, _A in CLASSES
                        for B in (tile_b, tile_b // 2)}
                       | {(_CPU_TILE_B // nd, N) for _L, N, *_ in CLASSES
                          for nd in (1, 2, 8)})

LAUNCH_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include "poa_rank_launch.h"
int main(int argc, char** argv) {
  for (int i = 1; i + 1 < argc; i += 2) {
    const int B = atoi(argv[i]), N = atoi(argv[i + 1]);
    const rank_launch::Shape s = rank_launch::rank_shape(B, N);
    printf("%d %d %d %lld %d %d\n", s.warps, s.windows,
           rank_launch::threads(s), rank_launch::smem_bytes(s, N),
           rank_launch::shape_ok(s, N), rank_launch::blocks(s, B));
  }
}
"""


@pytest.fixture(scope="module")
def rank_launch(tmp_path_factory):
    """(B, N) -> the launch kernel 4's source makes there (warps,
    windows, threads, shared bytes, taken, blocks): its launch header,
    csrc/poa_rank_launch.h, built with g++ (no CUDA in it)."""
    d = tmp_path_factory.mktemp("rank_launch")
    (d / "main.cpp").write_text(LAUNCH_MAIN)
    subprocess.run(["g++", "-std=c++17", f"-I{_build.SRC_DIR}",
                    str(d / "main.cpp"), "-o", str(d / "launch")],
                   check=True, capture_output=True, timeout=120)

    def launch(B, N):
        out = subprocess.run([str(d / "launch"), str(B), str(N)],
                             check=True, capture_output=True, text=True)
        return tuple(int(x) for x in out.stdout.split())

    return launch


@pytest.mark.parametrize("shape", RUNNER_SHAPES,
                         ids=[f"B{b}_N{n}" for b, n in RUNNER_SHAPES])
def test_rank_launch_shape_fits_the_card(rank_launch, shape):
    """Kernel 4's launch, as its source picks it, at every shape the
    runners launch: taken, a power of two of warps a window and no more
    than a warp per 32 nodes, at most 512 threads a block (the kernel's
    launch bound), at most 48 KB of shared memory (the wrapper sets no
    opt-in), blocks enough for B windows, the last one not empty, and
    the two class tiles at the design's launch (two warps a window and
    four windows a block at class 0, 16 warps and one window at class
    1: about 32 warps an SM of 132)."""
    B, N = shape
    warps, windows, threads, smem, ok, blocks = rank_launch(B, N)
    assert ok
    assert warps & (warps - 1) == 0 and 32 * (warps // 2) < N
    assert threads == 32 * warps * windows <= 512
    assert smem <= 48 * 1024
    assert (blocks - 1) * windows < B <= blocks * windows
    if (B, N) == (2048, 256):
        assert (warps, windows) == (2, 4)
    if (B, N) == (256, 1024):
        assert (warps, windows) == (16, 1)


@pytest.mark.parametrize("B, N, ok", [(1, 4088, 1), (1, 4089, 0),
                                      (2048, 4092, 1), (1, 0, 0)])
def test_rank_launch_refuses_what_the_kernel_cannot_hold(rank_launch, B, N,
                                                         ok):
    """A window past 48 KB of shared memory (N > 4,088 at 16 warps a
    window; one warp a window holds N = 4,092), or no node, takes no
    launch (hypo_poa_rank returns cudaErrorInvalidValue)."""
    assert rank_launch(B, N)[4] == ok


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _card_tile(ci):
    """(a tile at class ``ci``'s full shape, the states before each of
    its arm steps and the final one, all on the card, N, L)."""
    L, N, _K, B, _A = CLASSES[ci]
    tile, _ = tile_inputs(3, B, 16, L, (100, 400)[ci], 0.04, n_wild=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    states = []
    merge = TF.merge_arm

    def record(st, *args, **kw):
        states.append(TF.clone_state(st))
        return merge(st, *args, **kw)

    TF.merge_arm = record
    try:
        final = TF.run_arm_steps(*tile[:6], N=N, L=L, P=8, device=dev, **SC)
    finally:
        TF.merge_arm = merge
    return tile, states + [final], N, L


def head_and_rank_match(st, t, k, N, L):
    """The head (into fresh buffers) and kernel 4 (every leaf set) on the
    card against their plain versions; returns the head's outputs."""
    dev = st.node_code.device
    B, P = st.pred_nd.shape[0], st.pred_nd.shape[2]
    kt = torch.tensor([k], dtype=torch.int32, device=dev)
    out = cuda_rank.step_head(st, *t, kt, TF.head_buffers(B, N, L, P, dev),
                              N=N)
    want = TF._step_head_batch(st, *t, kt, N=N)
    for f in HEAD_FIELDS:
        assert torch.equal(getattr(out, f), getattr(want, f)), (f, k)
    for f in STEP_LEAVES:
        assert torch.equal(getattr(out.ra, f), getattr(want.ra, f)), (f, k)
    assert int(kt) == k
    for leaves in (FIELDS, STEP_LEAVES, cuda_rank.CONS_LEAVES):
        got = cuda_rank.rank_arrays(st, N, leaves)
        for f in leaves:
            assert torch.equal(getattr(got, f), getattr(want.ra, f)), (f, k)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 2049])
@pytest.mark.parametrize("ci", [0, 1])
def test_head_and_rank_match_plain_on_card(cuda_device, ci, B):
    """B windows drawn from a full-width tile of class ``ci`` (its states
    before each arm step on the card), made ragged: the step head and
    kernel 4 equal their plain versions at steps 0, 1, 2, the middle
    one, the last and the one after, and count one launch a call."""
    tile, states, N, L = _card_tile(ci)
    rng = np.random.default_rng(B + ci)
    rows = rng.integers(0, len(tile[5]), B)
    rows[0] = 0                            # a window that overflows
    sub = ragged((tile[0], tile[1], tile[2][rows], tile[3][rows],
                  tile[4][rows], tile[5][rows], tile[6][rows]), seed=B)
    t = tensors(sub, cuda_device)
    kmax = len(states) - 1
    before = (cuda_rank.step_head.launches, cuda_rank.rank_arrays.launches)
    ks = sorted({0, 1, 2, kmax // 2, kmax - 1, kmax})
    for k in ks:
        full = states[min(k, kmax)]
        st = TF.PoaState(*(x[torch.as_tensor(rows, device=cuda_device)]
                           .contiguous() for x in full))
        head_and_rank_match(st, t, k, N, L)
    assert cuda_rank.step_head.launches == before[0] + len(ks)
    assert cuda_rank.rank_arrays.launches == before[1] + 3 * len(ks)


# (N, L, P, B): N a multiple of 4 but not of a window's threads (fast
# path); N not a multiple of 4, and P other than 8 (generic path)
ODD_SHAPES = [(100, 48, 8, 7), (125, 60, 8, 9), (64, 30, 3, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ODD_SHAPES,
                         ids=[f"N{n}_P{p}" for n, _l, p, _b in ODD_SHAPES])
def test_head_and_rank_on_odd_shapes_on_card(cuda_device, shape):
    """The head and kernel 4 against their plain versions where N is no
    multiple of the window's threads, or takes the generic path (N not a
    multiple of 4, P other than 8, or a state array 4 bytes off 16-byte
    alignment), at every arm step of a ragged tile (its states made by
    the plain arm steps on the CPU)."""
    N, L, P, B = shape
    tile, _ = tile_inputs(5, B, 5, L, L - 10, 0.1, n_wild=1)
    tile = ragged(tile)
    states = []
    merge = TF.merge_arm

    def record(st, *args, **kw):
        states.append(TF.clone_state(st))
        return merge(st, *args, **kw)

    TF.merge_arm = record
    try:
        final = TF.run_arm_steps(*tile[:6], N=N, L=L, P=P, device=CPU, **SC)
    finally:
        TF.merge_arm = merge
    t = tensors(tile, cuda_device)
    on_card = [TF.PoaState(*(x.to(cuda_device) for x in st))
               for st in states + [final]]
    final = on_card[-1]
    for k, st in enumerate(on_card):
        head_and_rank_match(st, t, k, N, L)
    # pred_nd 4 bytes past a 16-byte boundary: the generic path
    buf = torch.empty(final.pred_nd.numel() + 1, dtype=torch.int32,
                      device=cuda_device)
    off = buf[1:].view(final.pred_nd.shape).copy_(final.pred_nd)
    assert off.is_contiguous() and off.data_ptr() % 16
    head_and_rank_match(final._replace(pred_nd=off), t, len(states), N, L)
