"""Seconds per polish outside the k-mer, alignment, segmentation, arm
and POA stages: the root ``polish`` span less the port's stage spans
that ``pipeline.kmers_s``, ``pipeline.alignments_s``,
``pipeline.segment_s``, ``pipeline.arms_s`` read and ``pipeline.poa``
(contig I/O, the FASTA, the runner's set-up, time in no stage)."""
from polishbench.program_spans import per_polish

STAGES = ("pipeline.solid_kmers", "pipeline.load_short_alignments",
          "pipeline.solid_positions", "pipeline.kmer_support",
          "pipeline.strong_regions", "pipeline.minimizer_support",
          "pipeline.window_division", "pipeline.short_arms",
          "pipeline.window_fill", "pipeline.long_arms", "pipeline.poa")


def read(t):
    whole = per_polish(t, "polish")
    if whole is None:
        return None
    return whole - per_polish(t, *STAGES)
