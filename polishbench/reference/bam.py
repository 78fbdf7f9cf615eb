"""BAM record fields, flags and BGZF blocks, from scratch (no htslib).

What the reference and the generator share: the record the polisher
reads (flag, tid, pos, mapq, cigar, sequence codes, qname, NM tag;
reference src/Alignment.cpp:514-571), the SAM flags it filters on
(src/Hypo.cpp:299), the NM tag's parse, and one BGZF block.  Records are
read by ``check.BamIndex`` and ``stretch.parse_records``, and written by
``gen._write_bam``.

Frozen from hypo_tpu_torch/io/bam.py (the port's copy of
hypo_tpu/io/bam.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

# CIGAR op characters by numeric code (htslib order)
CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

# bam_cigar_type: bit0 = consumes query, bit1 = consumes reference
_CIGAR_TYPE = np.array([3, 1, 2, 2, 1, 0, 0, 3, 3], dtype=np.uint8)

# BAM 4-bit nibble -> code (A0 C1 G2 T3, others N=4)
_NIB_TO_CODE = np.full(16, 4, dtype=np.uint8)
_NIB_TO_CODE[1], _NIB_TO_CODE[2], _NIB_TO_CODE[4], _NIB_TO_CODE[8] = 0, 1, 2, 3
_CODE_TO_NIB = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

# SAM flags (subset used; reference src/Hypo.cpp:299)
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400


def cigar_consumes(op: int) -> int:
    """bam_cigar_type: bit0 query, bit1 reference."""
    return int(_CIGAR_TYPE[op])


@dataclasses.dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int           # 0-based leftmost ref position
    mapq: int
    cigar_ops: np.ndarray   # uint8 op codes
    cigar_lens: np.ndarray  # uint32 lengths
    seq_codes: np.ndarray   # uint8 codes 0..4, full read as stored
    nm: Optional[int] = None


def _parse_nm(data: bytes, off: int) -> Optional[int]:
    """Walk BAM aux tags looking for NM (any int type)."""
    n = len(data)
    while off + 3 <= n:
        tag = data[off:off + 2]
        typ = data[off + 2:off + 3]
        off += 3
        if typ == b"A":
            val, off = data[off], off + 1
        elif typ == b"c":
            val, off = struct.unpack_from("<b", data, off)[0], off + 1
        elif typ == b"C":
            val, off = data[off], off + 1
        elif typ == b"s":
            val, off = struct.unpack_from("<h", data, off)[0], off + 2
        elif typ == b"S":
            val, off = struct.unpack_from("<H", data, off)[0], off + 2
        elif typ == b"i":
            val, off = struct.unpack_from("<i", data, off)[0], off + 4
        elif typ == b"I":
            val, off = struct.unpack_from("<I", data, off)[0], off + 4
        elif typ == b"f":
            val, off = struct.unpack_from("<f", data, off)[0], off + 4
        elif typ in (b"Z", b"H"):
            end = data.index(b"\x00", off)
            val, off = data[off:end], end + 1
        elif typ == b"B":
            sub = data[off:off + 1]
            (cnt,) = struct.unpack_from("<i", data, off + 1)
            size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2,
                    b"i": 4, b"I": 4, b"f": 4}[sub]
            val, off = None, off + 5 + cnt * size
        else:
            return None  # unknown tag type; bail out
        if tag == b"NM" and typ in b"cCsSiI":
            return int(val)
    return None


def _bgzf_block(payload: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25  # total block (hdr 18 + crc 4 + isize 4) - 1
    hdr = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                      ord("B"), ord("C"), 2, bsize)
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                    len(payload) & 0xFFFFFFFF)


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
