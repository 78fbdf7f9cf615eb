"""Seconds of a polish outside its POA stage, mean over the window's
polishes: each polish's Monitor ``Overall`` less its ``POA over N
windows`` stage (solid k-mers, contigs, the BAMs, support, regions,
arms, the FASTA; ``pipeline.polish``, ``kmers``, ``io.bam``,
``native.host_api``)."""


def read(t):
    if not t.polishes or len(t.totals) != t.polishes:
        return None
    return (sum(t.totals) - sum(t.stage_seconds("POA over"))) / t.polishes
