"""The port's own copy of the host layer against the JAX package's, on
the CPU: the simulator writes the same files, the command line with the
host engine (--no-device-poa) writes the same FASTA, with and without
the native host library, the solid-k-mer command line writes the same
bitmask, and the NumPy spec ColPoa gives the same consensus.  Every compared value is bytes or an integer: tolerance 0."""
import gzip
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from hypo_tpu import cli as jcli
from hypo_tpu import sim as jsim
from hypo_tpu.poa.colpoa_ref import ColPoa as JColPoa
from hypo_tpu_torch import cli as tcli
from hypo_tpu_torch import sim as tsim
from hypo_tpu_torch.poa import LOV, NW, ROV
from hypo_tpu_torch.poa.colpoa_ref import ColPoa as TColPoa


def _bytes(path, gz=False):
    with (gzip.open(path, "rb") if gz else open(path, "rb")) as fh:
        return fh.read()


@pytest.mark.parametrize("native", [True, False])
def test_sim_writes_the_same_files(tmp_path, monkeypatch, native):
    """Seeded hybrid simulation: identical draft, truth and BAMs, and the
    same reads once decompressed; through the native read composer and
    through the Python one (HYPO_SIM_PYTHON=1)."""
    if not native:
        monkeypatch.setenv("HYPO_SIM_PYTHON", "1")
    kw = dict(genome_size=12_000, seed=3, long_cov=8, dropout=(0.3, 0.4))
    ref = jsim.simulate(jsim.SimConfig(**kw), str(tmp_path / "jax"))
    out = tsim.simulate(tsim.SimConfig(**kw), str(tmp_path / "port"))
    for key in ("truth", "draft", "sr_bam", "lr_bam"):
        assert _bytes(out[key]) == _bytes(ref[key]), key
    assert _bytes(out["reads"], gz=True) == _bytes(ref["reads"], gz=True)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """An 8 kbp short-read and a 10 kbp hybrid simulation."""
    root = tmp_path_factory.mktemp("sims")
    return {
        "short": jsim.simulate(jsim.SimConfig(
            genome_size=8000, seed=11, draft_error_rate=0.012),
            str(root / "short")),
        "hybrid": jsim.simulate(jsim.SimConfig(
            genome_size=10_000, seed=22, draft_error_rate=0.015,
            long_cov=25, dropout=(0.4, 0.5)), str(root / "hybrid")),
    }


@pytest.mark.parametrize("kind", ["short", "hybrid"])
@pytest.mark.parametrize("native", [True, False])
def test_cli_host_engine_writes_the_same_fasta(sims, tmp_path, monkeypatch,
                                               kind, native):
    if not native:
        monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    paths = sims[kind]
    argv = ["-r", paths["reads"], "-d", paths["draft"], "-b",
            paths["sr_bam"], "-c", "30", "-s", str(paths["genome_size"]),
            "-t", "2", "--no-device-poa"]
    if paths["lr_bam"]:
        argv += ["-B", paths["lr_bam"]]
    jcli.main(argv + ["-o", str(tmp_path / "jax.fa"),
                      "--aux-dir", str(tmp_path / "aux_jax")])
    tcli.main(argv + ["-o", str(tmp_path / "port.fa"),
                      "--aux-dir", str(tmp_path / "aux_port")])
    jax_fa = _bytes(tmp_path / "jax.fa")
    assert len(jax_fa) > 0.9 * paths["genome_size"]
    assert hashlib.md5(_bytes(tmp_path / "port.fa")).hexdigest() == \
        hashlib.md5(jax_fa).hexdigest()


def test_kmers_command_line_writes_the_same_bitmask(sims, tmp_path):
    """``python -m hypo_tpu_torch.kmers`` and ``python -m hypo_tpu.kmers``
    on the short-read simulation's reads: the same k, words and count
    (the .npz files differ only in their zip timestamps)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for pkg in ("hypo_tpu_torch", "hypo_tpu"):
        out[pkg] = str(tmp_path / f"{pkg}.npz")
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.kmers", "-k", "11", "-i",
             sims["short"]["reads"], "-c", "30", "-o", out[pkg]],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert "solid kmers:" in r.stderr
    with np.load(out["hypo_tpu_torch"]) as got, \
            np.load(out["hypo_tpu"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key
        assert int(got["num_solid"]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colpoa_spec_gives_the_same_consensus(seed):
    """Noisy copies of a random truth as NW arms framed by J/O (4/5),
    LOV heads and ROV tails, with weights."""
    rng = np.random.default_rng(seed)
    sc = (5, -4, -8)
    for _ in range(6):
        truth = rng.integers(0, 4, int(rng.integers(20, 80)))
        jcp, tcp = JColPoa(*sc), TColPoa(*sc)
        for _k in range(int(rng.integers(2, 9))):
            r = rng.random(len(truth))
            s = np.where(r < 0.03, rng.integers(0, 4, len(truth)), truth)
            s = s[r >= 0.015].tolist()
            md = int(rng.choice([NW, NW, LOV, ROV]))
            if md == NW:
                s = [4] + s + [5]
            elif md == LOV:
                s = [4] + s[:max(1, len(s) // 2)]
            else:
                s = s[len(s) // 2:] + [5]
            w = int(rng.integers(1, 4))
            jcp.add(s, md, w=w)
            tcp.add(s, md, w=w)
        assert tcp.consensus() == jcp.consensus()
