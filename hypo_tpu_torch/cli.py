"""Command line of the PyTorch port, with hypo_tpu's flags;
``--device-poa`` runs window consensus on the CUDA device.

    python -m hypo_tpu_torch.cli -r reads.fq.gz -d draft.fa -b sr.bam \\
        -c 30 -s 4m -o polished.fa -t 8 --device-poa
    python -m hypo_tpu_torch.cli ... -B lr.bam --device-poa \\
        --device-poa-mode exact        # hybrid; LONG windows on the card
    HYPO_TPU_NO_NATIVE=1 python -m hypo_tpu_torch.cli ... --device-poa \\
        --device-poa-mode exact        # without the native libraries

Mode ``full`` (the default) runs each window's whole POA in device
tiles; mode ``exact`` runs the DP and traceback on the device and the
graph merges on the host.  Mode ``full`` needs the native host and POA
libraries: without them (``HYPO_TPU_NO_NATIVE=1``, or a failed g++
build) it exits before the host stages.  Exact mode and the host engine
(``--no-device-poa``) run without them.  The device runner's stats go
to stderr as one JSON object of the keys its mode moves: exact mode's
device_rounds, device_aligns, long_aligns and host_fallbacks; mode
``full``'s tile counts, trivial_windows, host_long_windows and
host_fallbacks.

Several processes polish one draft together with ``--nproc N --procid
i`` (one contiguous range of contigs each, the k-mer counts merged and
the FASTA gathered by rank 0 through the shared filesystem; give every
run a fresh ``--aux-dir`` and output path); ``--coordinator host:port``
also joins them in a torch.distributed (gloo) process group.  Mode
``full`` splits each tile over every visible CUDA device, or the first
``HYPO_POA_NDEV`` of them (``CUDA_VISIBLE_DEVICES`` chooses which are
visible).

``--trace-out PATH`` turns on the port's span recorder
(``utils.trace``) and writes its spans and counters to PATH when the
polish ends, as Chrome trace JSON (Perfetto or chrome://tracing load
it).

``build_parser`` and ``flags_from_args`` are copied from hypo_tpu/cli.py
(only the help texts name the CUDA device and torch.distributed), with
``--trace-out`` added.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .config import (STAGE_BEG, InputFlags, ScoreParams, get_expected_file_sz,
                     get_kmer_len)
from .pipeline.polish import Polisher, polish
from .utils import trace


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hypo_tpu_torch",
        description="hybrid assembly polisher; --device-poa runs window "
                    "consensus on a CUDA device (capabilities of "
                    "kensung-lab/hypo)")
    ap.add_argument("-r", "--reads-short", required=True, action="append",
                    help="short reads (fasta/fastq[.gz]); @file-of-names "
                         "supported; repeatable")
    ap.add_argument("-d", "--draft", required=True)
    ap.add_argument("-b", "--bam-sr", required=True)
    ap.add_argument("-c", "--coverage-short", type=int, required=True)
    ap.add_argument("-s", "--size-ref", required=True,
                    help="approx genome size (e.g. 4.6m, 3g)")
    ap.add_argument("-B", "--bam-lr", default="")
    ap.add_argument("-o", "--output", default="")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-p", "--processing-size", type=int, default=0)
    ap.add_argument("-k", "--kind-sr", default="sr", choices=["sr", "ccs"])
    ap.add_argument("-m", "--match-sr", type=int, default=5)
    ap.add_argument("-x", "--mismatch-sr", type=int, default=-4)
    ap.add_argument("-g", "--gap-sr", type=int, default=-8)
    ap.add_argument("-M", "--match-lr", type=int, default=3)
    ap.add_argument("-X", "--mismatch-lr", type=int, default=-5)
    ap.add_argument("-G", "--gap-lr", type=int, default=-4)
    ap.add_argument("-q", "--qual-map-th", type=int, default=2)
    ap.add_argument("-n", "--ned-th", type=int, default=20)
    ap.add_argument("-i", "--intermed", action="store_true")
    ap.add_argument("--device-poa", action="store_true", default=None,
                    help="run window consensus on the CUDA device "
                         "(default: the host engine)")
    ap.add_argument("--no-device-poa", dest="device_poa",
                    action="store_false",
                    help="force the host consensus engine")
    ap.add_argument("--device-poa-mode", default="full",
                    choices=["full", "exact"],
                    help="full: whole POA on the device in tiles; exact: "
                         "per-round device DP and traceback, host graph "
                         "merges")
    ap.add_argument("--aux-dir", default="aux")
    ap.add_argument("--nproc", type=int, default=1,
                    help="number of polishing processes (contigs shard "
                         "across them; shared filesystem)")
    ap.add_argument("--procid", type=int, default=0,
                    help="this process's rank in [0, nproc)")
    ap.add_argument("--coordinator", default="",
                    help="torch.distributed coordinator address "
                         "(host:port, served by rank 0); optional")
    ap.add_argument("--inspect", action="store_true",
                    help="write aux/regions.bed and aux/inspect.txt "
                         "(reference generate_inspect_file artifacts)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="record the polish's spans and counters and "
                         "write them to PATH as Chrome trace JSON")
    return ap


def flags_from_args(args) -> InputFlags:
    if args.gap_sr >= 0 or args.gap_lr >= 0:
        raise SystemExit("gap penalties must be negative")
    sr_files: List[str] = []
    for r in args.reads_short:
        if r.startswith("@"):
            with open(r[1:]) as fh:
                sr_files.extend(x.strip() for x in fh if x.strip())
        else:
            sr_files.append(r)
    for p in sr_files + [args.draft, args.bam_sr] + (
            [args.bam_lr] if args.bam_lr else []):
        if not os.path.exists(p):
            raise SystemExit(f"file does not exist: {p}")
    output = args.output
    if not output:
        base = os.path.basename(args.draft)
        stem = base.rsplit(".", 1)[0]
        output = f"hypo_{stem}.fasta"
    done_stage = STAGE_BEG
    stagefile = os.path.join(args.aux_dir, "stage.txt")
    if args.intermed and os.path.exists(stagefile):
        with open(stagefile) as fh:
            for line in fh:
                parts = line.split()
                if parts:
                    try:
                        done_stage = int(parts[-1])
                    except ValueError:
                        pass
    flags = InputFlags(
        sr_filenames=sr_files,
        sr_bam_filename=args.bam_sr,
        lr_bam_filename=args.bam_lr,
        draft_filename=args.draft,
        output_filename=output,
        score_params=ScoreParams(args.match_sr, args.mismatch_sr,
                                 args.gap_sr, args.match_lr,
                                 args.mismatch_lr, args.gap_lr),
        map_qual_th=args.qual_map_th,
        norm_edit_th=args.ned_th,
        threads=args.threads,
        processing_batch_size=args.processing_size,
        k=max(2, get_kmer_len(args.size_ref)),
        cov=args.coverage_short,
        sz_in_gb=get_expected_file_sz(args.size_ref, args.coverage_short),
        done_stage=done_stage,
        intermed=args.intermed,
        kind=args.kind_sr,
        aux_dir=args.aux_dir,
        use_device_poa=args.device_poa,
        device_poa_mode=args.device_poa_mode,
        inspect=args.inspect,
        num_processes=args.nproc,
        process_id=args.procid,
        coordinator=args.coordinator,
    )
    if not (0 <= flags.process_id < flags.num_processes):
        raise SystemExit("--procid must be in [0, --nproc)")
    return flags


def run(argv: Optional[List[str]] = None) -> Polisher:
    """Parse ``argv``, polish, print the device path's stats to stderr
    (and write the trace, with ``--trace-out``); returns the Polisher."""
    args = build_parser().parse_args(argv)
    flags = flags_from_args(args)
    print(f"[hypo_tpu_torch] k={flags.k} output={flags.output_filename}",
          file=sys.stderr)
    if args.trace_out:
        trace.enable()
        try:
            p = polish(flags)
        finally:
            trace.disable()
            trace.write_chrome(args.trace_out)
    else:
        p = polish(flags)
    if p.device_runner is not None:
        print(f"[hypo_tpu_torch] device POA stats ({flags.device_poa_mode}): "
              f"{json.dumps(p.device_runner.stats)}", file=sys.stderr)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
