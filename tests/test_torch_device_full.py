"""The port's tile program (hypo_tpu_torch.poa.device_full) against the
JAX package's (hypo_tpu.poa.device_full, XLA path) and against the NumPy
spec (hypo_tpu.poa.colpoa_ref.ColPoa), on CPU tensors.  Inputs come from
numpy seeds; every compared value is an integer, so the tolerance is 0.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.colpoa_ref import ColPoa
from hypo_tpu_torch.poa import device_full as TF
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
