"""End to end: on an 8 kbp simulation, the port's polisher (tile program
on CPU tensors, i.e. the kernels' plain versions) writes a FASTA
byte-identical to hypo_tpu's with --device-poa (JAX tile program) and
with --no-device-poa (native host engine)."""
import hashlib

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
