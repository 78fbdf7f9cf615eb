"""End to end, on CPU tensors (the kernels' plain versions): on an 8 kbp
short-read simulation the port's polisher (tile program) writes a FASTA
byte-identical to hypo_tpu's with --device-poa (JAX tile program) and
with --no-device-poa (native host engine); on a 9 kbp hybrid simulation
its exact mode writes the native host engine's FASTA, with the native
libraries and without them, and its full mode without one of them exits
before any host stage; on a 60 kbp simulation at 8x short-read
coverage, whose weak windows reach tile class 1, the port's full mode
writes the FASTA of hypo_tpu's host engine."""
import hashlib
import os

import pytest
import torch

from hypo_tpu.config import InputFlags, get_kmer_len
from hypo_tpu.pipeline.polish import polish as polish_ref
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.native import api as poa_api
from hypo_tpu_torch.pipeline.polish import Polisher, polish


def _md5(path):
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def test_port_fasta_matches_both_hypo_tpu_engines(tmp_path):
    paths = simulate(SimConfig(genome_size=8000, seed=7,
                               draft_error_rate=0.012), str(tmp_path))

    def flags(name, device_poa):
        return InputFlags(
            sr_filenames=[paths["reads"]],
            sr_bam_filename=paths["sr_bam"],
            draft_filename=paths["draft"],
            output_filename=str(tmp_path / name),
            k=max(2, get_kmer_len(str(paths["genome_size"]))),
            cov=paths["short_cov"],
            use_device_poa=device_poa,
            device_poa_mode="full")

    port = flags("port.fa", True)
    runner = polish(port, device=torch.device("cpu")).device_runner
    assert runner.stats["full_windows"] > 0
    md5 = _md5(port.output_filename)
    for name, device_poa in (("jax_device.fa", True), ("host.fa", False)):
        ref = flags(name, device_poa)
        polish_ref(ref)
        assert _md5(ref.output_filename) == md5, name


@pytest.fixture(scope="module")
def hybrid_sim(tmp_path_factory):
    """A 9 kbp hybrid simulation (test_e2e's) and the md5 of the FASTA
    that hypo_tpu's native host engine polishes from it."""
    tmp = tmp_path_factory.mktemp("hybrid")
    paths = simulate(SimConfig(genome_size=9000, seed=22,
                               draft_error_rate=0.015, long_cov=25,
                               dropout=(0.4, 0.5)), str(tmp))
    ref = _flags(paths, tmp / "host.fa", False, "full")
    polish_ref(ref)
    return paths, _md5(ref.output_filename)


def _flags(paths, out, device_poa, mode):
    return InputFlags(
        sr_filenames=[paths["reads"]],
        sr_bam_filename=paths["sr_bam"],
        lr_bam_filename=paths["lr_bam"],
        draft_filename=paths["draft"],
        output_filename=str(out),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"],
        use_device_poa=device_poa,
        device_poa_mode=mode)


def test_port_exact_mode_fasta_matches_host_engine(hybrid_sim, tmp_path):
    paths, md5 = hybrid_sim
    flags = _flags(paths, tmp_path / "exact.fa", True, "exact")
    runner = polish(flags, device=torch.device("cpu")).device_runner
    assert runner.stats["device_aligns"] > 0
    assert runner.stats["long_aligns"] > 0
    assert _md5(flags.output_filename) == md5


@pytest.mark.parametrize("mode,missing", [
    ("full", "HYPO_TPU_NO_NATIVE"), ("exact", "HYPO_TPU_NO_NATIVE"),
    ("full", "libhypo_poa")])
def test_port_without_the_native_libraries(
        hybrid_sim, tmp_path, monkeypatch, mode, missing):
    """Without the native libraries (HYPO_TPU_NO_NATIVE=1), or without
    the POA library alone: mode full exits before any host stage,
    naming what is missing and the modes that run; exact mode runs the
    pure-Python host stages and its runner, and writes the native host
    engine's FASTA."""
    if missing == "HYPO_TPU_NO_NATIVE":
        monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.setattr(poa_api, "available", lambda: False)
    paths, md5 = hybrid_sim
    flags = _flags(paths, tmp_path / f"no_native_{mode}.fa", True, mode)
    polisher = Polisher(flags, device=torch.device("cpu"))
    if mode == "exact":
        polisher.polish()
        assert polisher.device_runner.stats["device_aligns"] > 0
        assert _md5(flags.output_filename) == md5
        return
    with pytest.raises(SystemExit) as err:
        polisher.polish()
    message = str(err.value)
    assert "--device-poa-mode full needs the native host and POA " \
        "libraries" in message
    assert "--device-poa-mode exact or --no-device-poa" in message
    if missing == "HYPO_TPU_NO_NATIVE":
        assert "libhypo_host, libhypo_poa did not load (HYPO_TPU_NO_NATIVE " \
            "is set)" in message
    else:
        assert "and libhypo_poa did not load (a failed build or load)" \
            in message
    assert polisher.contigs == []        # the draft loads after the check
    assert not os.path.exists(flags.output_filename)


# md5 of hypo_tpu.cli --no-device-poa's FASTA from ``python -m
# hypo_tpu.sim --genome-size 60000 --short-cov 8 --seed 1`` polished
# with ``-c 8 -s 60k``
MD5_60K_8X = "843907f31cb7ab9c796681d6e7b93c6b"


def test_port_full_mode_reaches_class_1_at_8x(tmp_path):
    """Low short-read coverage leaves long gaps between solid k-mers, so
    some weak windows' arms pass class 0's L = 126: the class-1 tile
    program runs end to end, and the FASTA is hypo_tpu's host engine's."""
    paths = simulate(SimConfig(genome_size=60000, short_cov=8, seed=1),
                     str(tmp_path))

    def flags(name, device_poa):
        return InputFlags(
            sr_filenames=[paths["reads"]],
            sr_bam_filename=paths["sr_bam"],
            draft_filename=paths["draft"],
            output_filename=str(tmp_path / name),
            k=get_kmer_len("60k"), cov=8, use_device_poa=device_poa,
            device_poa_mode="full")

    port = flags("port.fa", True)
    stats = polish(port, device=torch.device("cpu")).device_runner.stats
    assert stats["class_tiles"][1] >= 1 and stats["class_windows"][1] > 0
    ref = flags("host.fa", False)
    polish_ref(ref)
    assert _md5(port.output_filename) == _md5(ref.output_filename) \
        == MD5_60K_8X
