"""The plain reference (``polishbench.reference``) polishes as the
port's host engine does, and imports nothing of the port or of JAX."""
import json
import os
import subprocess
import sys

import pytest

from polishbench import check, gen
from polishbench.registry import ROOT


def _port_polish(sim: dict, out: str, size: int) -> None:
    cmd = [sys.executable, "-m", "hypo_tpu_torch.cli", "-r", sim["reads"],
           "-d", sim["draft"], "-b", sim["sr_bam"], "-c", "30", "-s",
           str(size), "-t", "2", "-o", out, "--no-device-poa", "--aux-dir",
           os.path.join(os.path.dirname(out), "aux")]
    if sim["lr_bam"]:
        cmd += ["-B", sim["lr_bam"]]
    subprocess.run(cmd, check=True, cwd=ROOT, capture_output=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))


@pytest.mark.parametrize("hybrid", [False, True], ids=["short", "hybrid"])
def test_reference_equals_the_ports_host_engine(tmp_path, hybrid):
    size = 20000
    kw = {"long_cov": 25, "dropout": (0.3, 0.33)} if hybrid else {}
    sim = gen.simulate(str(tmp_path / "in"), 1, size, workers=2, **kw)
    out = str(tmp_path / "host.fa")
    _port_polish(sim, out, size)
    name, seq = check.read_fasta(sim["draft"])[0]
    spec = {"margin": 1500, "pad": 0, "bp": len(seq), "count": 1}
    ref = check.Reference(sim, 9, 30, spec, [(0, len(seq))], workers=2)
    texts = ref.run()
    assert ref.stats["interiors"] == 1
    assert ref.stats["poa_windows"] > 0
    if hybrid:
        assert ref.stats["long_windows"] > 0
    assert check.judge(out, name, texts) == 0
    # a wrong polish is caught: the draft itself, and one base changed
    assert check.judge(sim["draft"], name, texts) == 1
    polished = check.read_fasta(out)[0][1]
    at = polished.find(texts[0]) + len(texts[0]) // 2
    bad = tmp_path / "bad.fa"
    flip = "A" if polished[at] != "A" else "C"
    bad.write_text(f">{name}\n{polished[:at]}{flip}{polished[at + 1:]}\n")
    assert check.judge(str(bad), name, texts) == 1


def test_reference_loads_no_program_and_no_jax(tmp_path):
    """The reference and the check, run in a process of their own, put
    no module of hypo_tpu_torch, hypo_tpu or JAX in sys.modules
    (top-level names compared whole)."""
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from polishbench import check, gen, control
def main():
    sim = gen.simulate({str(tmp_path / 'in')!r}, 3, 20000, workers=2,
                       long_cov=10, dropout=(0.3, 0.33))
    name, seq = check.read_fasta(sim["draft"])[0]
    spec = {{"margin": 1500, "pad": 0, "bp": len(seq), "count": 1}}
    for ctl in (False, True):
        check.Reference(sim, 9, 30, spec, [(0, len(seq))], workers=2,
                        control=ctl).run()
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print(json.dumps(tops))
if __name__ == "__main__":
    main()
"""
    script = tmp_path / "ref_only.py"
    script.write_text(code)
    r = subprocess.run([sys.executable, str(script)], check=True,
                       capture_output=True, text=True, cwd=str(tmp_path))
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "polishbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hypo_tpu", "hypo_tpu_torch",
                       "torch"}


def test_control_fails_the_check(tmp_path):
    """The control (int8 score cells), spliced into the draft as a
    polished FASTA and judged as a run judges a polish, is not correct;
    the reference, spliced the same way, is."""
    from polishbench import control
    sim = gen.simulate(str(tmp_path / "in"), 5, 20000, workers=2)
    name, seq = check.read_fasta(sim["draft"])[0]
    spec = {"margin": 1500, "pad": 0, "bp": len(seq), "count": 1}
    out = control.judge_sides(sim, 9, 30, spec, [(0, len(seq))],
                              str(tmp_path))
    assert out["reference"]["correct"] is True
    assert out["control"]["correct"] is False
    assert out["control"]["checks"]["stretches_wrong"]["value"] == 1
    assert out["control"]["checks"]["polishes_wrong"]["value"] == 1


def test_splice_puts_each_text_in_its_span():
    spans = [(2, 4), None, (8, 10)]
    texts = ["xx", None, "yyy"]
    assert check.splice("AAAACCCCGGGG", spans, texts) == "AAxxCCCCyyyGG"
