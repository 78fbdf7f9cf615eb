"""The port's whole-batch entry point
(hypo_tpu_torch.poa.device_full.poa_full_batch) against the JAX
package's (hypo_tpu.poa.device_full.poa_full_batch, with its XLA DP and
with its Pallas kernels in interpret mode) and against the NumPy spec
(hypo_tpu.poa.colpoa_ref.ColPoa), on CPU tensors: the kernels' plain
versions.  Inputs come from numpy seeds (test_device_full's recipe);
every compared value is an integer, so the tolerance is 0.  Card-only
cases carry the ``cuda`` marker and hold the kernels to the CPU result.
"""
import functools

import numpy as np
import pytest
import torch

from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.colpoa_ref import ColPoa
from hypo_tpu_torch.poa import device_full as TF
from test_device_full import _random_jobs

SC = dict(m=5, n=-4, g=-8)
CPU = torch.device("cpu")

# name: (N, L, K, P, B, seed, truth length, error rate) -- the first
# three are test_device_full's cases (:60-125), the last the class-0
# caps (L = 126, N = 256, K = 16, P = 8) at a small B
CASES = {"caps128_64_12_8": (128, 64, 12, 8, 8, 136, 36, 0.12),
         "caps96_48_10_4": (96, 48, 10, 4, 8, 100, 36, 0.12),
         "overflow64_48_12_2": (64, 48, 12, 2, 16, 99, 30, 0.25),
         "class0_caps": (256, 126, 16, 8, 6, 7, 100, 0.08)}


def case_inputs(name):
    N, L, K, P, B, seed, tlen, err = CASES[name]
    arms, alen, amode, narms, specs = _random_jobs(
        np.random.default_rng(seed), B, K, L, tlen=tlen, err=err)
    return (arms, alen, amode, narms), specs, dict(N=N, L=L, K=K, P=P, **SC)


@functools.lru_cache(maxsize=None)
def jax_outputs(name, dp_impl):
    inputs, _specs, kw = case_inputs(name)
    return tuple(np.asarray(x) for x in
                 DF.poa_full_batch(*inputs, **kw, dp_impl=dp_impl))


def spec_overflows(seqs, N, P):
    """Whether ColPoa's graph passes the (N, P) caps on ``seqs``, and the
    spec's (codes, supports) when it does not."""
    cp = ColPoa(SC["m"], SC["n"], SC["g"])
    for s, md in seqs:
        cp.add(s, md)
        if (len(cp.node_code) > N
                or max((len(p) for p in cp.pred_nd), default=0) > P):
            return True, None
    return False, cp.consensus()


@pytest.mark.parametrize("dp_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_poa_full_batch_matches_jax_and_spec(name, dp_impl):
    """All four outputs equal the JAX package's, dtype included; every
    window the spec does not overflow equals ColPoa, and every window it
    overflows is flagged; the caller's tensors are unchanged."""
    inputs, specs, kw = case_inputs(name)
    given = [torch.from_numpy(x.copy()) for x in inputs]
    before = [x.clone() for x in given]
    got = TF.poa_full_batch(*given, **kw)
    for x, y in zip(given, before):
        assert torch.equal(x, y)
    want = jax_outputs(name, dp_impl)
    for g, w in zip(got, want):
        assert g.device == CPU
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    cc, cs, cl, ovf = (x.numpy() for x in got)
    checked = 0
    for b, seqs in enumerate(specs):
        spec_ovf, spec = spec_overflows(seqs, kw["N"], kw["P"])
        if spec_ovf:
            assert ovf[b], "the spec overflows this window"
        elif not ovf[b]:
            assert cc[b, :cl[b]].tolist() == spec[0]
            assert cs[b, :cl[b]].tolist() == spec[1]
            checked += 1
    if name.startswith("overflow"):
        assert ovf.any() and checked >= 1
    else:
        assert checked >= len(specs) // 2


def test_poa_full_batch_takes_int8_codes_and_numpy_alike():
    """The tile program's int8 codes (as tensors) and the JAX package's
    int32 codes (as numpy arrays) give the same outputs; the numpy
    arrays are unchanged."""
    inputs, _specs, kw = case_inputs("caps96_48_10_4")
    before = [x.copy() for x in inputs]
    from_numpy = TF.poa_full_batch(*inputs, **kw, device="cpu")
    for x, y in zip(inputs, before):
        assert np.array_equal(x, y)
    arms, alen, amode, narms = inputs
    from_int8 = TF.poa_full_batch(
        torch.from_numpy(arms.astype(np.int8)),
        torch.from_numpy(alen.astype(np.int16)),
        torch.from_numpy(amode.astype(np.int8)),
        torch.from_numpy(narms.astype(np.int64)), **kw)
    for a, b in zip(from_numpy, from_int8):
        assert torch.equal(a, b)
    for a, w in zip(from_numpy, jax_outputs("caps96_48_10_4", "xla")):
        assert np.array_equal(a.numpy(), w)


def test_poa_full_batch_refuses_wrong_shapes_and_numpy_without_a_card():
    inputs, _specs, kw = case_inputs("caps96_48_10_4")
    arms, alen, amode, narms = inputs
    with pytest.raises(ValueError, match="arm_len"):
        TF.poa_full_batch(arms, alen[:, :-1], amode, narms, **kw,
                          device="cpu")
    with pytest.raises(ValueError, match="arms"):
        TF.poa_full_batch(arms.astype(np.float32), alen, amode, narms, **kw,
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TF.poa_full_batch(*inputs, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# the two shape classes (poa.full_runner.CLASSES) at a small B, and the
# random windows' truth length
CARD_CLASSES = {"class0": (256, 126, 16, 8, 48, 100),
                "class1": (1024, 510, 16, 8, 8, 400)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES) + sorted(CARD_CLASSES))
def test_poa_full_batch_on_the_card_equals_the_cpu(cuda_device, name):
    """The five kernels' result equals the plain versions' on the same
    inputs, at the JAX tests' small shapes and at both shape classes;
    the inputs on the card are unchanged."""
    if name in CASES:
        inputs, _specs, kw = case_inputs(name)
    else:
        N, L, K, P, B, tlen = CARD_CLASSES[name]
        arms, alen, amode, narms, _specs = _random_jobs(
            np.random.default_rng(N), B, K, L, tlen=tlen, err=0.04)
        inputs = (arms, alen, amode, narms)
        kw = dict(N=N, L=L, K=K, P=P, **SC)
    want = TF.poa_full_batch(*inputs, **kw, device="cpu")
    given = [torch.from_numpy(x).to(cuda_device) for x in inputs]
    before = [x.clone() for x in given]
    got = TF.poa_full_batch(*given, **kw)
    torch.cuda.synchronize()
    for x, y in zip(given, before):
        assert torch.equal(x, y)
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g.cpu(), w)
