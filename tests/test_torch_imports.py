"""The port imports no JAX and nothing of the JAX package (hypo_tpu),
and neither does chip_smoke.py; the port builds its native host
libraries into its git-ignored _build/ directory; asking it for the
device path without CUDA fails loudly; its kernel wrappers never fall
back for a tensor that is not on the CPU."""
import ast
import os
import re
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
            "hypo_tpu_torch.poa.cuda_tb, hypo_tpu_torch.poa.cuda_rank, "
            "hypo_tpu_torch.poa.cuda_merge, hypo_tpu_torch.parallel, "
            "hypo_tpu_torch.parallel.distributed, hypo_tpu_torch.entry, "
            "hypo_tpu_torch.kmers.__main__, hypo_tpu_torch.bench, "
            "hypo_tpu_torch.tools.profile_device, "
            "hypo_tpu_torch.tools.long_window_stats, "
            "hypo_tpu_torch.tools.timing; "
            "from hypo_tpu_torch.poa.device_full import poa_full_batch; "
            "from hypo_tpu_torch.poa.dp import traceback_from_bp; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib')))")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_port_stands_alone(tmp_path):
    """Every module of the port imported, a tiny simulation polished by
    its command line with the host engine (native host library): no
    module of hypo_tpu, jax or jaxlib was loaded."""
    code = f"""
import importlib, os, pkgutil, sys
import hypo_tpu_torch
names = [mod.name for mod in
         pkgutil.walk_packages(hypo_tpu_torch.__path__, "hypo_tpu_torch.")]
assert {{"hypo_tpu_torch.entry", "hypo_tpu_torch.kmers.__main__",
         "hypo_tpu_torch.parallel.distributed",
         "hypo_tpu_torch.parallel.mesh", "hypo_tpu_torch.bench",
         "hypo_tpu_torch.tools.profile_device",
         "hypo_tpu_torch.tools.long_window_stats",
         "hypo_tpu_torch.tools.timing", "hypo_tpu_torch.poa.cuda_rank",
         "hypo_tpu_torch.poa.cuda_merge"}} <= set(names), names
for name in names:
    importlib.import_module(name)
from hypo_tpu_torch import cli, sim
from hypo_tpu_torch.native import host_api
assert host_api.available()
d = {str(tmp_path)!r}
p = sim.simulate(sim.SimConfig(genome_size=6000, seed=2), d)
cli.main(["-r", p["reads"], "-d", p["draft"], "-b", p["sr_bam"], "-c", "30",
          "-s", "6000", "--no-device-poa", "-o", os.path.join(d, "out.fa")])
assert os.path.getsize(os.path.join(d, "out.fa")) > 5000
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("hypo_tpu", "jax", "jaxlib")))
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    build = os.path.join(ROOT, "hypo_tpu_torch", "_build")
    for lib in ("libhypo_host.so", "libhypo_poa.so", "libhypo_bam.so"):
        assert os.path.exists(os.path.join(build, lib)), lib
    native = os.path.join(ROOT, "hypo_tpu_torch", "native")
    assert not [f for f in os.listdir(native) if f.endswith(".so")]


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """No import of hypo_tpu or jax, and no string naming a module of
    hypo_tpu (as in ``-m hypo_tpu.cli``), in chip_smoke.py."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("hypo_tpu", "jax", "jaxlib"), \
                name
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.fullmatch(r"hypo_tpu(\.\w+)*", node.value), \
                node.value


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def cli_inputs(tmp_path):
    """Files that pass the CLI's existence checks (lr.bam too, for -B);
    polishing stops before reading them."""
    paths = []
    for name in ("reads.fq", "draft.fa", "sr.bam", "lr.bam"):
        p = tmp_path / name
        p.write_text("")
        paths.append(str(p))
    reads, draft, bam, _lr = paths
    return ["-m", "hypo_tpu_torch.cli", "-r", reads, "-d", draft, "-b", bam,
            "-c", "30", "-s", "8k", "-o", str(tmp_path / "out.fa")]


@pytest.mark.parametrize("extra,message", [
    (["--device-poa"], "CUDA"),
    (["--device-poa", "--device-poa-mode", "exact"], "CUDA"),
    (["--nproc", "2", "--procid", "2"], "--procid must be in"),
    # scores the DP kernel's int16 cells cannot hold at the mode's largest
    # shape (full: N 1024 + L 510; exact: N 1024 + L 1024), refused before
    # any host stage; scores a mode does not launch are not checked
    (["--device-poa", "-m", "22"], "int16"),
    (["--device-poa", "-m", "21"], "CUDA"),
    (["--device-poa", "--device-poa-mode", "exact", "-g", "-16"], "int16"),
    (["--device-poa", "--device-poa-mode", "exact", "-B", "LR", "-M", "16"],
     "int16"),
    (["--device-poa", "--device-poa-mode", "exact", "-M", "16"], "CUDA"),
    (["--device-poa", "-B", "LR", "-M", "30"], "CUDA"),
])
def test_cli_refuses_what_it_cannot_run(cli_inputs, extra, message):
    if message == "CUDA" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lr = os.path.join(os.path.dirname(cli_inputs[-1]), "lr.bam")
    r = _run(cli_inputs + [lr if a == "LR" else a for a in extra])
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
                                 A=8, devices="cpu")
    with pytest.raises(ValueError, match="expected"):
        tile(np.zeros((8, 12), np.int8), np.zeros(8, np.int32),
             np.full((5, 3), -1, np.int32), np.zeros((5, 3), np.int8),
             np.zeros((5, 3), np.int32), np.zeros(5, np.int32),
             np.zeros(5, np.int32))
