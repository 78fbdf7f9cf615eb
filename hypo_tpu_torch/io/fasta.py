"""FASTA/FASTQ streaming reader/writer (gzip-transparent).

Replaces the reference's kseq.h usage (reference include/kseq.h,
instantiated at globalDefs.hpp:38).  Reads both FASTA and FASTQ, plain or
gzip-compressed, yielding (name, sequence) tuples.  The name is the first
whitespace-delimited token, like kseq.

Copied from hypo_tpu/io/fasta.py.
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Tuple


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def read_fastx(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq) from a FASTA or FASTQ file (optionally .gz)."""
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            header = fh.readline()
            name = header.split()[0] if header.split() else ""
            chunks: List[str] = []
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(chunks)
                    rest = line[1:]
                    name = rest.split()[0] if rest.split() else ""
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield name, "".join(chunks)
        elif first == "@":
            # FASTQ
            header = fh.readline()
            while True:
                name = header.split()[0] if header.split() else ""
                seq = fh.readline().strip()
                fh.readline()  # '+'
                fh.readline()  # qual
                yield name, seq
                nxt = fh.read(1)
                if not nxt:
                    return
                assert nxt == "@", "malformed FASTQ"
                header = fh.readline()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")


def write_fasta(path: str, records, width: int = 0) -> None:
    """Write (name, seq) records.  width=0 -> single-line sequences,
    matching the reference's output format (reference src/Contig.cpp:345-365
    writes the whole contig on one line)."""
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            if width <= 0:
                fh.write(seq + "\n")
            else:
                for i in range(0, len(seq), width):
                    fh.write(seq[i:i + width] + "\n")
