"""The port imports no JAX; asking it for the device path without CUDA
fails loudly; its kernel wrappers never fall back for a tensor that is
not on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hypo_tpu_torch.poa import cuda_consensus, cuda_poa
from hypo_tpu_torch.poa import device_full as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_no_jax():
    code = ("import sys, hypo_tpu_torch, hypo_tpu_torch.cli, "
            "hypo_tpu_torch.poa.full_runner, hypo_tpu_torch.pipeline.polish,"
            " hypo_tpu_torch.state, hypo_tpu_torch.poa.batch, "
            "hypo_tpu_torch.poa.cuda_tb; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib')))")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def cli_inputs(tmp_path):
    """Files that pass the CLI's existence checks; polishing stops
    before reading them."""
    paths = []
    for name in ("reads.fq", "draft.fa", "sr.bam"):
        p = tmp_path / name
        p.write_text("")
        paths.append(str(p))
    reads, draft, bam = paths
    return ["-m", "hypo_tpu_torch.cli", "-r", reads, "-d", draft, "-b", bam,
            "-c", "30", "-s", "8k", "-o", str(tmp_path / "out.fa")]


@pytest.mark.parametrize("extra,message", [
    (["--device-poa"], "CUDA"),
    (["--device-poa", "--device-poa-mode", "exact"], "CUDA"),
    (["--nproc", "2"], "not ported"),
])
def test_cli_refuses_what_it_cannot_run(cli_inputs, extra, message):
    if message == "CUDA" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run(cli_inputs + extra)
    assert r.returncode != 0
    assert message in r.stderr
    assert not os.path.exists(cli_inputs[-1])


def test_dp_wrapper_raises_for_a_device_without_kernel():
    meta = torch.device("meta")
    B, N, L, P = 3, 16, 10, 4
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=meta)  # noqa
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_poa.poa_dp_batch(
            i(B, N), i(B, N, P), i(B, N), torch.zeros(B, N, dtype=torch.bool,
                                                      device=meta),
            i(B), i(B, L), i(B), i(B), N=N, L=L, P=P, m=5, n=-4, g=-8)


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda_device):
    """On the card a bad argument raises: it is not sent to the plain
    version."""
    B, N, L, P = 3, 16, 10, 4
    i = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device=cuda_device)
    ie = torch.zeros(B, N, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="node_code has dtype"):
        cuda_poa.poa_dp_batch(
            i(B, N).long(), i(B, N, P), i(B, N), ie, i(B), i(B, L), i(B),
            i(B), N=N, L=L, P=P, m=5, n=-4, g=-8)
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_poa.poa_dp_batch(
            i(B, N), i(B, N, P).cpu(), i(B, N), ie, i(B), i(B, L), i(B),
            i(B), N=N, L=L, P=P, m=5, n=-4, g=-8)
    st = TF.init_state(N, P, B, cuda_device)
    ra = TF._rank_arrays_batch(st, N)
    with pytest.raises(ValueError, match="pred_w_r has dtype"):
        cuda_consensus.heaviest_bundle(
            ra.pred_ranks, ra.pred_w_r.long(), ra.pred_cnt_r, ra.is_end_r,
            ra.node_code_r, ra.node_sup_r, st.n_nodes,
            ra.rank_of[:, 0].contiguous(), N=N, P=P)


def test_tile_program_rejects_wrong_tile_shape():
    tile = TF.build_tile_program(N=32, L=12, K=3, P=4, m=5, n=-4, g=-8, B=4,
                                 A=8, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tile(np.zeros((8, 12), np.int8), np.zeros(8, np.int32),
             np.full((5, 3), -1, np.int32), np.zeros((5, 3), np.int8),
             np.zeros((5, 3), np.int32), np.zeros(5, np.int32),
             np.zeros(5, np.int32))
