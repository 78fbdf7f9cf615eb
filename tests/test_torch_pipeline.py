"""End to end, on CPU tensors (the kernels' plain versions): on an 8 kbp
short-read simulation the port's polisher (tile program) writes a FASTA
byte-identical to hypo_tpu's with --device-poa (JAX tile program) and
with --no-device-poa (native host engine); on a 9 kbp hybrid simulation
its exact mode, and its full mode without the native host library, both
write the native host engine's FASTA."""
import hashlib

import pytest
import torch

from hypo_tpu.config import InputFlags, get_kmer_len
from hypo_tpu.pipeline.polish import polish as polish_ref
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.pipeline.polish import polish


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


def test_port_full_mode_without_native_library_matches_host_engine(
        hybrid_sim, tmp_path, monkeypatch):
    """HYPO_TPU_NO_NATIVE=1: the orchestrator's pure-Python host stages
    and the tile runner's run_windows path."""
    monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    paths, md5 = hybrid_sim
    flags = _flags(paths, tmp_path / "no_native.fa", True, "full")
    runner = polish(flags, device=torch.device("cpu")).device_runner
    assert not runner.supports_native_tiles()
    assert runner.stats["full_windows"] > 0
    assert runner.stats["host_long_windows"] > 0
    assert _md5(flags.output_filename) == md5
