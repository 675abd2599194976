"""Plain readers of the program's output files: BGZF, BAM records, BAI and
TBI indexes, VCF lines.  Written from the SAM/BAM and tabix
specifications with the standard library and numpy; nothing here
imports the program."""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
SEQ_CODES = "=ACMGRSVTWYHKDBN"


class Stream(NamedTuple):
    data: bytes                      # the whole decompressed stream
    coffsets: np.ndarray             # file offset of each block
    ustarts: np.ndarray              # stream offset where each block starts


def read_bgzf(path: str) -> Stream:
    """Every BGZF block of ``path``, decompressed and joined."""
    with open(path, "rb") as fh:
        raw = fh.read()
    parts, coff, ustart = [], [], []
    pos = total = 0
    while pos < len(raw):
        if raw[pos:pos + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{path}: no BGZF block at {pos}")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        bsize = None
        x = pos + 12
        while x < pos + 12 + xlen:
            si1, si2, slen = raw[x], raw[x + 1], struct.unpack_from(
                "<H", raw, x + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, x + 4)[0]
            x += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: block at {pos} has no BSIZE")
        end = pos + bsize + 1
        block = zlib.decompress(raw[pos + 12 + xlen:end - 8], -15)
        isize = struct.unpack_from("<I", raw, end - 4)[0]
        if len(block) != isize or zlib.crc32(block) != struct.unpack_from(
                "<I", raw, end - 8)[0]:
            raise ValueError(f"{path}: block at {pos} fails its CRC/size")
        coff.append(pos)
        ustart.append(total)
        parts.append(block)
        total += len(block)
        pos = end
    return Stream(b"".join(parts), np.asarray(coff, np.int64),
                  np.asarray(ustart, np.int64))


def voffsets(stream: Stream, offs: np.ndarray) -> np.ndarray:
    """Virtual offsets (coffset << 16 | offset in block) of stream
    offsets; an offset at a block's end belongs to the next block."""
    offs = np.asarray(offs, np.int64)
    b = np.searchsorted(stream.ustarts, offs, side="right") - 1
    return (stream.coffsets[b] << 16) | (offs - stream.ustarts[b])


class Bam(NamedTuple):
    refs: List[Tuple[str, int]]
    text: str
    data: bytes
    off: np.ndarray                  # stream offset of each record
    vo: np.ndarray                   # virtual offset of each record
    tid: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    bin: np.ndarray
    flag: np.ndarray
    l_seq: np.ndarray
    mtid: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    names: List[str]
    cigars: List[List[Tuple[str, int]]]
    reflen: np.ndarray               # reference bases the CIGAR covers


def read_bam(path: str) -> Bam:
    st = read_bgzf(path)
    d = st.data
    if d[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM")
    l_text = struct.unpack_from("<i", d, 4)[0]
    text = d[8:8 + l_text].decode()
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", d, p)[0]
    p += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", d, p)[0]
        name = d[p + 4:p + 4 + ln].rstrip(b"\0").decode()
        refs.append((name, struct.unpack_from("<i", d, p + 4 + ln)[0]))
        p += 8 + ln
    offs = []
    n = len(d)
    while p < n:
        offs.append(p)
        p += 4 + struct.unpack_from("<i", d, p)[0]
    if p != n:
        raise ValueError(f"{path}: last record runs past the stream")
    off = np.asarray(offs, np.int64)
    arr = np.frombuffer(d, np.uint8)

    def field(o, dtype):
        w = np.dtype(dtype).itemsize
        idx = off[:, None] + o + np.arange(w)
        return arr[idx].copy().view(dtype)[:, 0] if len(off) else \
            np.zeros(0, dtype)

    tid, pos = field(4, "<i4"), field(8, "<i4")
    l_name, mapq = field(12, "u1"), field(13, "u1")
    bin_, n_cig = field(14, "<u2"), field(16, "<u2")
    flag, l_seq = field(18, "<u2"), field(20, "<i4")
    mtid, mpos, tlen = field(24, "<i4"), field(28, "<i4"), field(32, "<i4")
    names, cigars = [], []
    reflen = np.zeros(len(off), np.int64)
    for i in range(len(off)):
        o = int(off[i]) + 36
        ln = int(l_name[i])
        names.append(d[o:o + ln - 1].decode())
        o += ln
        nc = int(n_cig[i])
        ops = struct.unpack_from(f"<{nc}I", d, o)
        cig = [(CIGAR_OPS[v & 15], v >> 4) for v in ops]
        cigars.append(cig)
        reflen[i] = sum(n for op, n in cig if op in "MDN=X")
    return Bam(refs, text, d, off, voffsets(st, off), tid, pos, mapq, bin_,
               flag, l_seq, mtid, mpos, tlen, names, cigars, reflen)


def record_seq(bam: Bam, i: int) -> str:
    o = int(bam.off[i]) + 36
    d = bam.data
    o += d[o - 36 + 12] + 4 * len(bam.cigars[i])
    n = int(bam.l_seq[i])
    raw = d[o:o + (n + 1) // 2]
    out = []
    for b in raw:
        out.append(SEQ_CODES[b >> 4])
        out.append(SEQ_CODES[b & 15])
    return "".join(out[:n])


def record_tags(bam: Bam, i: int) -> Dict[str, object]:
    d = bam.data
    o = int(bam.off[i])
    end = o + 4 + struct.unpack_from("<i", d, o)[0]
    n = int(bam.l_seq[i])
    o += 36 + d[o + 12] + 4 * len(bam.cigars[i]) + (n + 1) // 2 + n
    tags = {}
    fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
           "I": "<I", "f": "<f"}
    while o < end:
        key = d[o:o + 2].decode()
        t = chr(d[o + 2])
        o += 3
        if t == "A":
            tags[key] = chr(d[o])
            o += 1
        elif t in fmt:
            tags[key] = struct.unpack_from(fmt[t], d, o)[0]
            o += struct.calcsize(fmt[t])
        elif t in "ZH":
            z = d.index(b"\0", o)
            tags[key] = d[o:z].decode()
            o = z + 1
        elif t == "B":
            sub = chr(d[o])
            cnt = struct.unpack_from("<i", d, o + 1)[0]
            w = struct.calcsize(fmt[sub])
            tags[key] = list(struct.unpack_from(
                f"<{cnt}{fmt[sub][1]}", d, o + 5))
            o += 5 + cnt * w
        else:
            raise ValueError(f"record {i}: tag {key} of unknown type {t}")
    return tags


def reg2bin(beg: int, end: int) -> int:
    """The SAM specification's bin of the 0-based interval [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """Every bin that may hold a record overlapping [beg, end)."""
    end -= 1
    out = [0]
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(first + (beg >> shift), first + (end >> shift) + 1))
    return out


def _read_bins(d: bytes, p: int, n_ref: int):
    """Per reference: {bin: [(beg, end) chunks]} and the linear index."""
    out = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", d, p)[0]
        p += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", d, p)
            p += 8
            ch = struct.unpack_from(f"<{2 * n_chunk}Q", d, p)
            p += 16 * n_chunk
            bins[b] = list(zip(ch[0::2], ch[1::2]))
        n_intv = struct.unpack_from("<i", d, p)[0]
        p += 4
        lin = struct.unpack_from(f"<{n_intv}Q", d, p)
        p += 8 * n_intv
        out.append((bins, lin))
    return out, p


def read_bai(path: str):
    with open(path, "rb") as fh:
        d = fh.read()
    if d[:4] != b"BAI\x01":
        raise ValueError(f"{path}: not a BAI")
    n_ref = struct.unpack_from("<i", d, 4)[0]
    return _read_bins(d, 8, n_ref)[0]


def read_tbi(path: str):
    """(sequence names, per-reference bins) of a tabix index."""
    d = zlib.decompress(open(path, "rb").read(), 31)
    if d[:4] != b"TBI\x01":
        raise ValueError(f"{path}: not a TBI")
    n_ref, _fmt, _cs, _cb, _ce, _meta, _skip, l_nm = struct.unpack_from(
        "<8i", d, 4)
    names = d[36:36 + l_nm].rstrip(b"\0").decode().split("\0")
    return names, _read_bins(d, 36 + l_nm, n_ref)[0]


def query_hits(index, tid: int, beg: int, end: int,
               vo: np.ndarray) -> np.ndarray:
    """Indices of the records (by their virtual offsets ``vo``, in file
    order) that the index's chunks for [beg, end) on ``tid`` take in."""
    if tid >= len(index):
        return np.zeros(0, np.int64)
    bins, _ = index[tid]
    hit = np.zeros(len(vo), bool)
    for b in reg2bins(beg, end):
        for cb, ce in bins.get(b, ()):
            lo = np.searchsorted(vo, cb, side="left")
            hi = np.searchsorted(vo, ce, side="left")
            hit[lo:hi] = True
    return np.nonzero(hit)[0]


class VcfRecord(NamedTuple):
    chrom: str
    pos: int                         # 1-based
    ref: str
    alt: List[str]
    qual: float
    filter: str
    info: Dict[str, str]
    fmt: List[str]
    samples: List[Dict[str, str]]


def read_vcf(path: str):
    """(sample names, records, their virtual offsets) of a bgzipped VCF."""
    st = read_bgzf(path)
    d = st.data
    samples, recs, offs = [], [], []
    p = 0
    while p < len(d):
        e = d.index(b"\n", p)
        line = d[p:e].decode()
        if line.startswith("#CHROM"):
            samples = line.split("\t")[9:]
        elif not line.startswith("#") and line:
            f = line.split("\t")
            info = {}
            for kv in f[7].split(";"):
                k, _, v = kv.partition("=")
                info[k] = v
            fmt = f[8].split(":") if len(f) > 8 else []
            recs.append(VcfRecord(
                f[0], int(f[1]), f[3], f[4].split(","),
                float(f[5]) if f[5] != "." else 0.0, f[6], info, fmt,
                [dict(zip(fmt, s.split(":"))) for s in f[9:]]))
            offs.append(p)
        p = e + 1
    return samples, recs, voffsets(st, np.asarray(offs, np.int64))
