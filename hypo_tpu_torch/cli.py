"""Command line of the PyTorch port: hypo_tpu's flags (hypo_tpu.cli),
with ``--device-poa`` running window consensus on the CUDA device.

    python -m hypo_tpu_torch.cli -r reads.fq.gz -d draft.fa -b sr.bam \\
        -c 30 -s 4m -o polished.fa -t 8 --device-poa

Not ported yet: ``--device-poa-mode exact`` and multi-process runs
(``--nproc`` > 1, ``--coordinator``); both exit with an error.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

from hypo_tpu.cli import build_parser, flags_from_args

from .pipeline.polish import Polisher, polish


def run(argv: Optional[List[str]] = None) -> Polisher:
    """Parse ``argv``, polish, print the device path's stats to stderr;
    returns the Polisher."""
    ap = build_parser()
    ap.prog = "hypo_tpu_torch"
    ap.description = ("hybrid assembly polisher; --device-poa runs window "
                      "consensus on a CUDA device (PyTorch port)")
    flags = flags_from_args(ap.parse_args(argv))
    if flags.num_processes > 1 or flags.coordinator:
        raise SystemExit("hypo_tpu_torch: multi-process polishing "
                         "(--nproc > 1, --coordinator) is not ported")
    print(f"[hypo_tpu_torch] k={flags.k} output={flags.output_filename}",
          file=sys.stderr)
    p = polish(flags)
    if p.device_runner is not None:
        print(f"[hypo_tpu_torch] device POA stats: "
              f"{json.dumps(p.device_runner.stats)}", file=sys.stderr)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
