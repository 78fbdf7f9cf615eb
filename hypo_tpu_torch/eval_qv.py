"""QV / accuracy evaluation: edit distance of draft and polished
assemblies against the truth, reported as a consensus QV
(QV = -10*log10(errors/bases), the metric the reference's paper uses).

Run as: python -m hypo_tpu_torch.eval_qv truth.fa draft.fa polished.fa

Copied from hypo_tpu/eval_qv.py.
"""
from __future__ import annotations

import math
import sys
from typing import Dict

from .io.fasta import read_fastx
from .utils.alnutil import edit_distance


def qv(errors: int, bases: int) -> float:
    if errors == 0:
        return float("inf")
    return -10.0 * math.log10(errors / bases)


def compare(truth_path: str, asm_path: str) -> Dict[str, float]:
    truth = dict(read_fastx(truth_path))
    total_ed = 0
    total_bases = 0
    for name, seq in read_fastx(asm_path):
        t = truth.get(name)
        if t is None:
            continue
        total_ed += edit_distance(t, seq)
        total_bases += len(t)
    return {"edit_distance": total_ed, "bases": total_bases,
            "qv": qv(total_ed, max(1, total_bases))}


def main() -> None:
    truth, *asms = sys.argv[1:]
    for asm in asms:
        r = compare(truth, asm)
        print(f"{asm}: edit_distance={r['edit_distance']} "
              f"bases={r['bases']} QV={r['qv']:.2f}")


if __name__ == "__main__":
    main()
