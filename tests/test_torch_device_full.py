"""The port's tile program (hypo_tpu_torch.poa.device_full) against the
JAX package's (hypo_tpu.poa.device_full, XLA path) and against the NumPy
spec (hypo_tpu.poa.colpoa_ref.ColPoa), on CPU tensors.  Inputs come from
numpy seeds; every compared value is an integer, so the tolerance is 0.

The tile program runs a tile as begin, step x kmax and finish on fixed
buffers, the arm index a device counter; on the CPU it calls those parts
as they are (on a CUDA device it replays their graphs), so the CPU cases
here run the same code on the same buffers, tile after tile.  Card-only
cases carry the ``cuda`` marker.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.colpoa_ref import ColPoa
from hypo_tpu_torch import _build
from hypo_tpu_torch.poa import cuda_consensus, cuda_poa, cuda_tb
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa import full_runner as tfull
from hypo_tpu_torch.state import state_from_numpy, state_to_numpy
from test_device_full import _random_jobs

SC = dict(m=5, n=-4, g=-8)
CPU = torch.device("cpu")


def tile_inputs(seed, B, K, L, tlen, err, n_wild=0):
    """A tile of random windows (test_device_full's recipe) as the tile
    program takes it: one pool row per arm, weights 1-3, curation
    thresholds 0-2.  The first n_wild windows get K-1 unrelated
    full-length arms, so their graphs overflow N = 2L."""
    rng = np.random.default_rng(seed)
    arms, alen, amode, narms, specs = _random_jobs(rng, B, K, L, tlen, err)
    for b in range(n_wild):
        specs[b] = []
        for k in range(K - 1):
            s = [4] + [int(x) for x in rng.integers(0, 4, L - 2)] + [5]
            arms[b, k] = s
            alen[b, k] = L
            amode[b, k] = 0
            specs[b].append((s, 0))
        narms[b] = K - 1
    A = B * K
    idx = np.arange(A, dtype=np.int32).reshape(B, K)
    idx[np.arange(K)[None, :] >= narms[:, None]] = -1
    aw = rng.integers(1, 4, (B, K)).astype(np.int32)
    th = rng.integers(0, 3, B).astype(np.int32)
    pool = arms.reshape(A, L).astype(np.int8)
    plen = alen.reshape(A).astype(np.int32)
    weighted = [[(s, md, int(aw[b, k])) for k, (s, md) in enumerate(sp)]
                for b, sp in enumerate(specs)]
    return (pool, plen, idx, amode.astype(np.int8), aw, narms, th), weighted


@functools.lru_cache(maxsize=None)
def _jax_step(N, L, P):
    return jax.jit(functools.partial(DF._arm_step_batch, N=N, L=L, P=P,
                                     dp_impl="xla", **SC))


def jax_arm_steps(tile, N, L, P):
    """Yields (state before the step, step inputs) for every arm step of
    the JAX tile program's loop, then (final state, None)."""
    pool, plen, idx, amode, aw, narms, _th = tile
    st = DF._bcast_state(N, P, idx.shape[0])
    for k in range(int(narms.max())):
        rows = idx[:, k]
        active = (k < narms) & (rows >= 0)
        rr = np.maximum(rows, 0)
        inp = (pool[rr].astype(np.int32),
               np.where(active, plen[rr], 0).astype(np.int32),
               amode[:, k].astype(np.int32), active, aw[:, k])
        yield st, inp
        st = _jax_step(N, L, P)(st, *inp)
    yield st, None


# (N, L, K, P, B, tlen, err, wild windows)
STEP_CASES = {"P4": (96, 48, 8, 4, 10, 30, 0.15, 0),
              "P2_overflow": (64, 48, 8, 2, 10, 30, 0.25, 1)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_arm_step_matches_jax_leaf_by_leaf(case):
    N, L, K, P, B, tlen, err, wild = STEP_CASES[case]
    tile, _specs = tile_inputs(11, B, K, L, tlen, err, wild)
    n_ovf = 0
    for st, inp in jax_arm_steps(tile, N, L, P):
        want = {f: np.asarray(getattr(st, f)) for f in DF.PoaState._fields}
        st_t = state_from_numpy(st, CPU)
        assert all(np.array_equal(v, want[f])
                   for f, v in state_to_numpy(st_t).items())
        if inp is None:
            n_ovf = int(want["ovf"].sum())
            break
        out_j = _jax_step(N, L, P)(st, *inp)
        out_t = TF._arm_step_batch(
            st_t, *(torch.as_tensor(x) for x in inp), N=N, L=L, P=P, **SC)
        got = state_to_numpy(out_t)
        for f in DF.PoaState._fields:
            assert np.array_equal(got[f], np.asarray(getattr(out_j, f))), f
    assert (n_ovf > 0) == (wild > 0)


# class shapes scaled down: (L, N, K, P, B, tlen)
TILE_CASES = {"class0_small": (40, 80, 6, 8, 12, 30),
              "class1_small": (100, 200, 5, 8, 6, 80)}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_program_bytes_match_jax(case):
    L, N, K, P, B, tlen = TILE_CASES[case]
    tile, _specs = tile_inputs(5, B, K, L, tlen, 0.12, n_wild=1)
    A = tile[0].shape[0]
    kw = dict(N=N, L=L, K=K, P=P, B=B, A=A, **SC)
    want = np.asarray(DF.build_tile_program(**kw, dp_impl="xla",
                                            ndev=1)(*tile))
    got = TF.build_tile_program(**kw, devices=CPU)(*tile)
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, N // 2 + 4)
    assert np.array_equal(got.numpy(), want)
    assert want[0, N // 2 + 2] == 1          # the wild window overflowed
    assert not want[1:, N // 2 + 2].all()


def test_consensus_matches_colpoa_spec():
    L, N, K, P, B = 48, 128, 10, 8, 10
    tile, specs = tile_inputs(3, B, K, L, 36, 0.12)
    st = TF.run_arm_steps(*tile[:6], N=N, L=L, P=P, device=CPU, **SC)
    cc, cs, cl = (x.numpy() for x in TF._consensus_batch(st, N=N, P=P))
    ovf = st.ovf.numpy()
    checked = 0
    for b in np.nonzero(~ovf)[0]:
        cp = ColPoa(SC["m"], SC["n"], SC["g"])
        for s, md, w in specs[b]:
            cp.add(s, md, w=w)
        codes, sup = cp.consensus()
        assert cc[b, :cl[b]].tolist() == codes
        assert cs[b, :cl[b]].tolist() == sup
        checked += 1
    assert checked >= B // 2


# -- the replayable program over consecutive tiles ----------------------------

def class_tile(ci, seed, kgen, n_wild=0, max_arms=None):
    """A tile at shape class ``ci``'s caps and the CPU tile size (B =
    _CPU_TILE_B, A = 2 B K, as FullDeviceRunner._class_shape): random
    windows of 3..kgen-1 arms (tile_inputs; at most ``max_arms``), the
    first n_wild of them overflowing."""
    L, N, K, _B, _A = tfull.CLASSES[ci]
    B = tfull._CPU_TILE_B
    A = 2 * B * K
    (pool, plen, idx, amode, aw, narms, th), _ = tile_inputs(
        seed, B, kgen, L, (100, 300)[ci], 0.12, n_wild)
    if max_arms is not None:
        narms = np.minimum(narms, max_arms)
        idx[np.arange(kgen)[None, :] >= narms[:, None]] = -1
    wide = lambda x, fill: np.pad(  # noqa: E731
        x, ((0, 0), (0, K - kgen)), constant_values=fill)
    pool_a = np.zeros((A, L), np.int8)
    pool_a[:len(pool)] = pool
    plen_a = np.zeros(A, np.int32)
    plen_a[:len(plen)] = plen
    return (pool_a, plen_a, wide(idx, -1), wide(amode, 0), wide(aw, 0),
            narms, th)


def class_kw(ci):
    L, N, K, _B, _A = tfull.CLASSES[ci]
    B = tfull._CPU_TILE_B
    return dict(N=N, L=L, K=K, P=tfull.P_FULL, B=B, A=2 * B * K, **SC)


def consecutive_tiles(ci):
    """Three tiles, in the order they go through one program: the first
    with an overflowing window (4 unrelated full-length arms), the
    second with fewer arms than the first, the third with more again
    (at most 3 arms a window in class 1, whose plain DP is slow on the
    CPU)."""
    kgen = (5, 4)[ci]
    return (class_tile(ci, 21, 5, n_wild=1),
            class_tile(ci, 22, kgen, max_arms=2),
            class_tile(ci, 23, kgen))


def ragged(tile, seed=0):
    """``tile`` (tile_inputs' or class_tile's arrays) with the ragged arm
    rows a tile may hold: every 7th window with no arm (narms 0, idx
    -1), every 5th from window 1 with three arms or more a -1 at arm 1,
    and every 6th from window 2 pool rows (of the first ``plen > 0``
    ones) set past its narms."""
    pool, plen, idx, amode, aw, narms, th = tile
    idx, narms = idx.copy(), narms.copy()
    B, K = idx.shape
    idx[::7] = -1
    narms[::7] = 0
    hole = [b for b in range(1, B, 5) if narms[b] >= 3]
    idx[hole, 1] = -1
    rng = np.random.default_rng(seed)
    for b in range(2, B, 6):
        if b % 7:
            idx[b, narms[b]:] = rng.integers(0, int((plen > 0).sum()),
                                             K - narms[b])
    return pool, plen, idx, amode, aw, narms, th


def ragged_tiles(ci):
    """Two tiles, in the order they go through one program: a ragged one
    (ragged), then the second of consecutive_tiles."""
    tile = class_tile(ci, 24, (5, 4)[ci], max_arms=(None, 3)[ci])
    return ragged(tile, seed=24), consecutive_tiles(ci)[1]


@functools.lru_cache(maxsize=None)
def _jax_program(ci):
    return DF.build_tile_program(**class_kw(ci), dp_impl="xla", ndev=1)


@functools.lru_cache(maxsize=None)
def jax_tile_bytes(ci, tiles=consecutive_tiles):
    """hypo_tpu's tile program (XLA, one device) on ``tiles(ci)``."""
    return [np.asarray(_jax_program(ci)(*t)) for t in tiles(ci)]


def program_matches_jax(ci, ndev, tiles, want):
    """One program instance takes ``tiles`` back to back (all queued
    before the first output is read): every tile's bytes equal ``want``
    (the JAX tile program's)."""
    prog = TF.build_tile_program(**class_kw(ci), devices=[CPU] * ndev)
    outs = [prog(*t) for t in tiles]
    assert len(prog.blocks) == ndev
    for i, (got, w) in enumerate(zip(outs, want)):
        assert got.dtype == torch.int8 and tuple(got.shape) == w.shape
        assert np.array_equal(got.numpy(), w), f"tile {i}"


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("ci", [0, 1])
def test_replayable_program_matches_jax_over_consecutive_tiles(ci, ndev):
    """One program instance takes three tiles back to back (all queued
    before the first output is read) on its fixed buffers, each block
    looping to its own largest arm count; every tile's bytes equal the
    JAX tile program's.  JAX runs on one device: the split is the
    port's, and its bytes must not depend on it."""
    N = class_kw(ci)["N"]
    tiles = consecutive_tiles(ci)
    want = jax_tile_bytes(ci)
    assert want[0][0, N // 2 + 2] == 1            # overflowed
    assert tiles[1][5].max() < tiles[0][5].max()  # fewer arms than before
    program_matches_jax(ci, ndev, tiles, want)


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("ci", [0, 1])
def test_replayable_program_matches_jax_over_ragged_tiles(ci, ndev):
    """The same over ragged_tiles: windows with no arm, a -1 in
    mid-row and rows past narms, whose arms the step head fetches as the
    JAX package's tile body does."""
    tiles = ragged_tiles(ci)
    idx, narms = tiles[0][2], tiles[0][5]
    assert (narms == 0).any() and ((idx[:, 1] < 0) & (narms > 1)).any()
    assert (idx[np.arange(idx.shape[1])[None, :] >= narms[:, None]]
            >= 0).any()
    program_matches_jax(ci, ndev, tiles, jax_tile_bytes(ci, ragged_tiles))


def test_a_step_that_always_reads_arm_0_fails_the_comparison(monkeypatch):
    """The arm index is the device counter k: a step that leaves it at 0
    merges every window's first arm again and again, and the bytes no
    longer equal JAX's."""
    step = TF._Block.step

    def stuck(self):
        step(self)
        self.k.zero_()

    monkeypatch.setattr(TF._Block, "step", stuck)
    tile = consecutive_tiles(0)[0]
    got = TF.build_tile_program(**class_kw(0), devices=CPU)(*tile)
    assert not np.array_equal(got.numpy(), jax_tile_bytes(0)[0])


def test_launches_under_capture_count_at_each_replay(monkeypatch):
    """A kernel launch made while the stream captures a graph is not
    counted then; the capture's recording holds it, and each replay of
    the graph adds it (device_full._replay)."""
    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with _build.recording() as recorded:
        _build.count_launch(wrapper)
        _build.count_launch(wrapper)
    _build.count_launch(wrapper)        # capturing, no recording open
    assert wrapper.launches == 0 and recorded == {wrapper: 2}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    _build.count_launch(wrapper)
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    for _ in range(3):
        TF._replay(Graph(), recorded)
    assert len(replays) == 3 and wrapper.launches == 1 + 3 * 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [0, 1])
def test_graph_tiles_equal_eager_tiles_and_count_replays(cuda_device, ci):
    """On the card: three tiles queued back to back through one program
    equal the eager tiles (run_tile_eager); the capture runs each part
    eagerly once (one launch of each kernel) and adds no launch itself;
    every tile adds kmax launches of kernels 1 and 3 and one of kernel
    2."""
    kw = class_kw(ci)
    counters = (cuda_poa.poa_dp_batch, cuda_tb.poa_tb_matched,
                cuda_consensus.heaviest_bundle)
    for c in counters:
        c.launches = 0
    prog = TF.build_tile_program(**kw, devices=cuda_device)
    tiles = consecutive_tiles(ci)
    outs = [prog(*t) for t in tiles]
    torch.cuda.synchronize()
    steps = sum(int(t[5].max()) for t in tiles)
    assert [c.launches for c in counters] == [1 + steps, 1 + steps, 1 + 3]
    assert prog.blocks[0].capture_stats["seconds"] > 0
    eager_kw = {k: kw[k] for k in ("N", "L", "P", "m", "n", "g")}
    for i, (t, out) in enumerate(zip(tiles, outs)):
        want = TF.run_tile_eager(*t, **eager_kw, device=cuda_device)
        assert torch.equal(out, want), f"tile {i}"
