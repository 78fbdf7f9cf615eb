"""The check's control: the plain reference put in the program's place
with its POA's score cells held in int8, the precision below the int16
cells of the port's DP kernel (``csrc/poa_dp.cu``; ``check_scores``
keeps every short-read score inside int16).

The DP fills its matrix exactly, then the cells are stored saturated
to [-128, 127] before the traceback reads them, as a kernel with int8
cells would hold them; the traceback then loses its path wherever a
score left that range, and the consensus it builds is wrong there.

    python3 polishbench/control.py --workload bact4m_sr.cov30 --seed 7

makes the cell's inputs from the seed (as a run does), runs the
reference and the control over the stretches a run draws, splices each
side's texts into the draft as a polished FASTA, and judges both FASTAs
as a run judges a polish (``check.verdict`` against the reference's
texts, with ``check.LIMITS``).  It prints one JSON line: each side's
numbers, its ``correct``, and its time.  The control's ``correct`` has
to come out false and the reference's true.  It runs no polish and
needs no card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from polishbench.reference.align import PoaAligner  # noqa: E402
from polishbench.reference.engine import ConsensusEngine  # noqa: E402

INT8 = (-128, 127)


class Int8Aligner(PoaAligner):
    """``PoaAligner`` whose score cells are stored as int8."""

    def _backtrack(self, H, *args):
        np.clip(H, *INT8, out=H)
        return super()._backtrack(H, *args)


def control_engine(sp) -> ConsensusEngine:
    eng = ConsensusEngine(sp)
    eng.short_aligner = Int8Aligner(sp.sr_match, sp.sr_mismatch, sp.sr_gap)
    eng.long_aligner = Int8Aligner(sp.lr_match, sp.lr_mismatch, sp.lr_gap)
    return eng


def judge_sides(inputs: dict, k: int, cov: int, spec: dict,
                stretches, work: str) -> dict:
    """The reference and the control over ``stretches``, each spliced
    into the draft, written as a polished FASTA and judged by
    ``check.verdict`` against the reference's texts."""
    from polishbench import check
    name, draft = check.read_fasta(inputs["draft"])[0]
    out, ref_texts = {}, None
    for side, control in (("reference", False), ("control", True)):
        t0 = time.perf_counter()
        ref = check.Reference(inputs, k, cov, spec, stretches,
                              control=control)
        texts = ref.run()
        ref_texts = texts if ref_texts is None else ref_texts
        path = os.path.join(work, f"{side}.fa")
        with open(path, "w") as fh:
            fh.write(f">{name}\n{check.splice(draft, ref.spans, texts)}\n")
        checks, correct = check.verdict([path], name, ref_texts, ref.stats)
        out[side] = {"correct": correct, "checks": checks,
                     "seconds": time.perf_counter() - t0, "stats": ref.stats}
    return out


def main(argv=None) -> None:
    import argparse

    from polishbench import check, gen, registry
    from polishbench.run import flags_k
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    opts = ap.parse_args(argv)
    cell = registry.Cell(opts.workload, registry.benchmark())
    cfg, mx = cell.config, cell.mix
    with tempfile.TemporaryDirectory(prefix="polishbench-control-") as work:
        inputs = gen.simulate_cell(os.path.join(work, "in"), opts.seed, cfg,
                                   mx)
        draft = check.read_fasta(inputs["draft"])[0][1]
        stretches = check.plan(opts.seed, len(draft), mx)
        out = {"workload": opts.workload, "seed": opts.seed}
        out.update(judge_sides(inputs, flags_k(cfg), mx["reads"]["short_cov"],
                               mx["check"], stretches, work))
    for side in ("reference", "control"):
        for name, c in out[side]["checks"].items():
            print(f"{side} {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
