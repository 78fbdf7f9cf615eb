"""Would LONG pseudo-windows fit a device tile class?  The counterpart of
``tools/long_window_stats.py``, on the port's own polisher.

    python -m hypo_tpu_torch.tools.long_window_stats SIM_DIR [--out FASTA]

Polishes a hybrid simulation (``python -m hypo_tpu_torch.sim ...
--long-cov 25``; its reads.fq.gz, sr.bam, lr.bam and draft.fa) with the
host engine and, for every LONG window that reaches consensus, records
the device-tile viability of its first-round job: arms before
deduplication, distinct (sequence, mode) arms after it (the device
pool's cost), the longest sequence, the draft's length, and whether the
job fits tile class 1 (L=510, N=1024, K=16: poa.full_runner.CLASSES).
It spies on ``ConsensusEngine.generate_consensus_batch`` and builds each
job with ``DeviceConsensusRunner._build_long_job`` (host code: no device
is used).  Prints the same statistics, in the same words, as the JAX
package's tool; the polished FASTA goes to ``--out`` (by default a file
in a temporary directory, removed at the end).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np


def collect(sim: str, out: str) -> list:
    """Polish ``sim`` into ``out``; one (raw arms, distinct arms, longest
    sequence, draft length, fits class 1, note) tuple per LONG window."""
    from ..config import InputFlags, ScoreParams, get_kmer_len
    from ..pipeline.polish import Polisher
    from ..poa import engine as eng_mod
    from ..poa.batch import DeviceConsensusRunner
    from ..poa.full_runner import CLASSES

    L1, N1, K1, _B1, _A1 = CLASSES[1]
    stats = []
    runner = DeviceConsensusRunner(ScoreParams(), "cpu")
    orig = eng_mod.ConsensusEngine.generate_consensus_batch

    def spy(self, windows, nthreads=0):
        for w in windows:
            if getattr(w, "wtype", 0) == 0:
                continue
            raw = w.num_internal + w.num_pre + w.num_suf
            job = runner._build_long_job(
                w, backbone="".join("ACGT"[c] for c in w.draft),
                kind="long1")
            if job is None:
                stats.append((raw, 0, 0, len(w.draft), True, "no-job"))
                continue
            ext = set(job.seqs)     # the distinct (sequence, mode) arms
            maxl = max(len(s) for s, _m in ext)
            need_n = max(2 * maxl, maxl + 32)
            fits = maxl <= L1 and need_n <= N1 and len(ext) <= K1
            stats.append((raw, len(ext), maxl, len(w.draft), fits, ""))
        return orig(self, windows, nthreads)

    flags = InputFlags(
        sr_filenames=[f"{sim}/reads.fq.gz"],
        sr_bam_filename=f"{sim}/sr.bam",
        lr_bam_filename=f"{sim}/lr.bam",
        draft_filename=f"{sim}/draft.fa",
        output_filename=out,
        aux_dir=os.path.join(os.path.dirname(out), "aux"),
        k=max(2, get_kmer_len("2m")),
        cov=30,
        threads=2,
    )
    eng_mod.ConsensusEngine.generate_consensus_batch = spy
    try:
        Polisher(flags).polish()
    finally:
        eng_mod.ConsensusEngine.generate_consensus_batch = orig
    return stats


def report(stats: list) -> None:
    """Print the statistics as the JAX package's tool does."""
    from ..poa.full_runner import CLASSES
    L1, _N1, K1, _B1, _A1 = CLASSES[1]
    if not stats:
        print("NO long windows reached consensus")
        return
    raw = np.array([s[0] for s in stats])
    ded = np.array([s[1] for s in stats])
    maxl = np.array([s[2] for s in stats])
    dlen = np.array([s[3] for s in stats])
    fits = np.array([s[4] for s in stats])
    print(f"long windows: {len(stats)}")
    print(f"raw arms       p50={np.median(raw):.0f} "
          f"p90={np.percentile(raw, 90):.0f} max={raw.max()}")
    print(f"dedup ext      p50={np.median(ded):.0f} "
          f"p90={np.percentile(ded, 90):.0f} max={ded.max()} "
          f"(K cap {K1})")
    print(f"dedup ratio    {ded.sum() / max(raw.sum(), 1):.2f} "
          f"(1.0 = no dedup benefit)")
    print(f"max seq len    p50={np.median(maxl):.0f} "
          f"p90={np.percentile(maxl, 90):.0f} max={maxl.max()} "
          f"(L cap {L1})")
    print(f"draft len      p50={np.median(dlen):.0f} max={dlen.max()}")
    print(f"fits class 1   {fits.mean() * 100:.1f}% "
          f"({fits.sum()}/{len(fits)})")
    over_k = (ded > K1).mean() * 100
    over_l = (maxl > L1).mean() * 100
    print(f"over K cap     {over_k:.1f}%   over L cap {over_l:.1f}%")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sim")
    ap.add_argument("--out", help="polished FASTA (default: a temporary "
                                  "file)")
    opts = ap.parse_args(argv)
    if opts.out:
        stats = collect(opts.sim, opts.out)
    else:
        with tempfile.TemporaryDirectory(prefix="hypo_longstats_") as tmp:
            stats = collect(opts.sim, os.path.join(tmp, "out.fa"))
    report(stats)


if __name__ == "__main__":
    main()
