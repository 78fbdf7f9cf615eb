"""Standalone solid-kmer discovery CLI — the equivalent of the
reference's suk binary (reference external/suk/src/main.cpp): count
k-mers in read files, pick cutoffs from the histogram, and store the
solid-kmer bitmask.

Usage:
    python -m hypo_tpu_torch.kmers -k 17 -i reads1.fq.gz reads2.fq.gz \
        -c 30 -o solid_kmers.npz

Copied from hypo_tpu/kmers/__main__.py (``prog`` and the log prefix
name the port).
"""
from __future__ import annotations

import argparse
import sys

from .solid import SolidKmers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="hypo_tpu_torch.kmers",
        description="Solid (unique genomic) k-mer discovery (suk role)")
    ap.add_argument("-k", "--kmer-len", type=int, required=True)
    ap.add_argument("-i", "--input", nargs="+", required=True,
                    help="read files (fasta/fastq[.gz])")
    ap.add_argument("-c", "--coverage", type=int, required=True,
                    help="approx short-read coverage")
    ap.add_argument("-o", "--output", default="solid_kmers.npz")
    args = ap.parse_args(argv)

    sk = SolidKmers(args.kmer_len).initialise(args.input, args.coverage)
    sk.store(args.output)
    print(f"[hypo_tpu_torch.kmers] k={args.kmer_len} solid kmers: "
          f"{sk.get_num_solid_kmers()} -> {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
