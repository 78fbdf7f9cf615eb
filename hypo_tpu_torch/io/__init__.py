"""Copied from hypo_tpu/io/__init__.py."""
from .fasta import read_fastx, write_fasta  # noqa: F401
from .bam import (  # noqa: F401
    BamRecord, read_alignments, write_bam, write_sam,
    CIGAR_OPS, cigar_consumes,
)
