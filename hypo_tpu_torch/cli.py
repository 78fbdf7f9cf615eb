"""Command line of the PyTorch port: hypo_tpu's flags (hypo_tpu.cli),
with ``--device-poa`` running window consensus on the CUDA device.

    python -m hypo_tpu_torch.cli -r reads.fq.gz -d draft.fa -b sr.bam \\
        -c 30 -s 4m -o polished.fa -t 8 --device-poa
    python -m hypo_tpu_torch.cli ... -B lr.bam --device-poa \\
        --device-poa-mode exact        # hybrid; LONG windows on the card
    HYPO_TPU_NO_NATIVE=1 python -m hypo_tpu_torch.cli ... --device-poa

Mode ``full`` (the default) runs each window's whole POA in device
tiles; mode ``exact`` runs the DP and traceback on the device and the
graph merges on the host.  Without hypo_tpu's native host library
(``HYPO_TPU_NO_NATIVE=1``, or a failed build) mode ``full`` takes the
runner's ``run_windows`` path.  The device runner's stats go to stderr
as one JSON object: device_rounds, device_aligns, long_aligns and
host_fallbacks for both modes, plus the tile counts of mode ``full``.

Not ported yet: multi-process runs (``--nproc`` > 1, ``--coordinator``),
which exit with an error.
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
        print(f"[hypo_tpu_torch] device POA stats ({flags.device_poa_mode}): "
              f"{json.dumps(p.device_runner.stats)}", file=sys.stderr)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
