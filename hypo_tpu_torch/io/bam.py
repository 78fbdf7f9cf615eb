"""BAM/SAM reading and writing, from scratch (no htslib).

Replaces the reference's htslib usage (reference src/Hypo.cpp:278-329 for
streaming, src/Alignment.cpp:514-571 for record fields).  BAM is BGZF
(concatenated gzip members) over a simple binary record format; Python's
gzip module transparently decompresses concatenated members, so reading
needs no custom BGZF layer.  Writing uses a minimal BGZF block writer.

Only the fields the polisher needs are materialized: flag, tid, pos, mapq,
cigar (ops+lens), 2-bit-able sequence codes, qname, and the NM tag.

Copied from hypo_tpu/io/bam.py.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..dna import encode as dna_encode

# CIGAR op characters by numeric code (htslib order)
CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

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
FSUPPLEMENTARY = 0x800


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

    def cigar_string(self) -> str:
        return "".join(f"{l}{CIGAR_OPS[o]}"
                       for o, l in zip(self.cigar_ops, self.cigar_lens))


def parse_cigar(cig: str) -> Tuple[np.ndarray, np.ndarray]:
    ops: List[int] = []
    lens: List[int] = []
    num = 0
    for ch in cig:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append(_OP_CODE[ch])
            lens.append(num)
            num = 0
    return (np.array(ops, dtype=np.uint8), np.array(lens, dtype=np.uint32))


# ---------------------------------------------------------------------------
# Reading

def _is_bam(path: str) -> bool:
    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return False
    with gzip.open(path, "rb") as g:
        return g.read(4) == b"BAM\x01"


def read_alignments(path: str) -> Tuple[List[Tuple[str, int]],
                                        Iterator[BamRecord]]:
    """Open a BAM or SAM file.  Returns (references, record_iterator) where
    references is [(name, length)] in header order (tid order)."""
    if _is_bam(path):
        return _read_bam(path)
    return _read_sam(path)


def _read_bam(path: str):
    g = gzip.open(path, "rb")
    assert g.read(4) == b"BAM\x01"
    (l_text,) = struct.unpack("<i", g.read(4))
    g.read(l_text)
    (n_ref,) = struct.unpack("<i", g.read(4))
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", g.read(4))
        name = g.read(l_name)[:-1].decode("ascii")
        (l_ref,) = struct.unpack("<i", g.read(4))
        refs.append((name, l_ref))

    def gen():
        unpack_core = struct.Struct("<iiBBHHHiiii").unpack
        while True:
            hdr = g.read(4)
            if len(hdr) < 4:
                break
            (block_size,) = struct.unpack("<i", hdr)
            data = g.read(block_size)
            (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _nrid, _npos, _tlen) = unpack_core(data[:32])
            off = 32
            qname = data[off:off + l_read_name - 1].decode("ascii")
            off += l_read_name
            cig = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=off)
            off += 4 * n_cigar
            ops = (cig & 0xF).astype(np.uint8)
            lens = (cig >> 4).astype(np.uint32)
            nbytes = (l_seq + 1) // 2
            packed = np.frombuffer(data, dtype=np.uint8, count=nbytes,
                                   offset=off)
            off += nbytes
            nibs = np.empty(nbytes * 2, dtype=np.uint8)
            nibs[0::2] = packed >> 4
            nibs[1::2] = packed & 0xF
            seq_codes = _NIB_TO_CODE[nibs[:l_seq]]
            off += l_seq  # qual
            nm = _parse_nm(data, off)
            yield BamRecord(qname, flag, refid, pos, mapq, ops, lens,
                            seq_codes, nm)
        g.close()

    return refs, gen()


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


def _read_sam(path: str):
    fh = open(path, "r")
    refs: List[Tuple[str, int]] = []
    pos0 = fh.tell()
    line = fh.readline()
    while line.startswith("@"):
        if line.startswith("@SQ"):
            name, ln = None, None
            for fld in line.rstrip("\n").split("\t")[1:]:
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            refs.append((name, ln))
        pos0 = fh.tell()
        line = fh.readline()
    fh.seek(pos0)
    ref_index = {name: i for i, (name, _) in enumerate(refs)}

    def gen():
        for raw in fh:
            f = raw.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            qname, flag, rname, pos1, mapq, cig = f[0], int(f[1]), f[2], \
                int(f[3]), int(f[4]), f[5]
            tid = ref_index.get(rname, -1) if rname != "*" else -1
            if cig == "*":
                ops = np.zeros(0, dtype=np.uint8)
                lens = np.zeros(0, dtype=np.uint32)
            else:
                ops, lens = parse_cigar(cig)
            seq_codes = (dna_encode(f[9]) if f[9] != "*"
                         else np.zeros(0, dtype=np.uint8))
            nm = None
            for tagf in f[11:]:
                if tagf.startswith("NM:i:"):
                    nm = int(tagf[5:])
                    break
            yield BamRecord(qname, flag, tid, pos1 - 1, mapq, ops, lens,
                            seq_codes, nm)
        fh.close()

    return refs, gen()


# ---------------------------------------------------------------------------
# Writing (used by the simulator/tests and as a general utility)

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


def _sam_line(rec: BamRecord, refs) -> str:
    rname = refs[rec.tid][0] if rec.tid >= 0 else "*"
    cig = rec.cigar_string() if len(rec.cigar_ops) else "*"
    seq = ("".join("ACGTN"[c] for c in rec.seq_codes)
           if len(rec.seq_codes) else "*")
    fields = [rec.qname, str(rec.flag), rname, str(rec.pos + 1),
              str(rec.mapq), cig, "*", "0", "0", seq, "*"]
    if rec.nm is not None:
        fields.append(f"NM:i:{rec.nm}")
    return "\t".join(fields)


def write_sam(path: str, refs: List[Tuple[str, int]],
              records) -> None:
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for name, ln in refs:
            fh.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        for rec in records:
            fh.write(_sam_line(rec, refs) + "\n")


class BgzfWriter:
    """Streaming BGZF writer (fixed 60000-byte payload blocks)."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data) -> None:
        self._buf += data
        while len(self._buf) >= 60000:
            self._fh.write(_bgzf_block(bytes(self._buf[:60000]),
                                       self._level))
            del self._buf[:60000]

    def close(self) -> None:
        if self._buf:
            self._fh.write(_bgzf_block(bytes(self._buf), self._level))
            self._buf = bytearray()
        self._fh.write(_BGZF_EOF)
        self._fh.close()


def bam_header_bytes(refs: List[Tuple[str, int]]) -> bytes:
    body = bytearray()
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    body += b"BAM\x01"
    body += struct.pack("<i", len(text))
    body += text.encode("ascii")
    body += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode("ascii") + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(body)


def write_bam(path: str, refs: List[Tuple[str, int]], records) -> None:
    blocks = [bam_header_bytes(refs)]
    for rec in records:
        qn = rec.qname.encode("ascii") + b"\x00"
        l_seq = len(rec.seq_codes)
        cig = ((rec.cigar_lens.astype(np.uint32) << 4)
               | rec.cigar_ops.astype(np.uint32)).astype("<u4").tobytes()
        nibs = _CODE_TO_NIB[np.minimum(rec.seq_codes, 4)]
        if l_seq % 2:
            nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
        packed = ((nibs[0::2] << 4) | nibs[1::2]).astype(np.uint8).tobytes()
        qual = b"\xff" * l_seq
        aux = b""
        if rec.nm is not None:
            aux = b"NMi" + struct.pack("<i", rec.nm)
        data = struct.pack("<iiBBHHHiiii", rec.tid, rec.pos, len(qn),
                           rec.mapq, 0, len(rec.cigar_ops), rec.flag, l_seq,
                           -1, -1, 0) + qn + cig + packed + qual + aux
        blocks.append(struct.pack("<i", len(data)) + data)

    w = BgzfWriter(path)
    for blk in blocks:
        w.write(blk)
    w.close()
