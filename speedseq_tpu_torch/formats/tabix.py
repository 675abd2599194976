"""Tabix .tbi index for bgzipped VCF (htslib tbx.c-equivalent).

Contract: src/samtools-1.3.1/htslib-1.3.1/tbx.c (333 LoC) — TBI = BAI-style
binning (14/5) plus a text-format config block; the reference builds these
via ``tabix -p vcf`` at bin/speedseq:815,1176,1629.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

from . import bgzf

TBI_MAGIC = b"TBI\x01"
TBX_VCF = 2  # preset: VCF (tbx.c conf_vcf)
LINEAR_SHIFT = 14


def _reg2bin(beg: int, end: int) -> int:
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


def _iter_lines_voff(path: str) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (line, voff_start, voff_end) over a BGZF text file.

    Virtual offsets are exact: computed from per-block compressed offsets
    (htslib/bgzf.h:187 coffset<<16|uoffset semantics).
    """
    carry = b""
    carry_voff = 0
    last_block_end_voff = 0
    for coffset, payload in bgzf.iter_blocks(path):
        if not payload:
            last_block_end_voff = coffset << 16
            continue
        pos = 0
        while True:
            nl = payload.find(b"\n", pos)
            if nl < 0:
                if pos < len(payload):
                    if not carry:
                        carry_voff = (coffset << 16) | pos
                    carry += payload[pos:]
                break
            line_start_voff = carry_voff if carry else (coffset << 16) | pos
            line = carry + payload[pos : nl + 1]
            carry = b""
            end_voff = (coffset << 16) | (nl + 1)
            if nl + 1 == len(payload):
                # offset at exact block end is represented as next block's
                # start — resolved by the caller via the following line's
                # start; use in-block form (htslib does the same on tell)
                pass
            yield line[:-1], line_start_voff, end_voff
            pos = nl + 1
        last_block_end_voff = coffset << 16 | len(payload)
    if carry:
        yield carry, carry_voff, last_block_end_voff


def build_tbi(vcf_gz_path: str, tbi_path: Optional[str] = None) -> str:
    """tabix -p vcf equivalent: index a coordinate-sorted bgzipped VCF."""
    tbi_path = tbi_path or vcf_gz_path + ".tbi"
    names: List[str] = []
    name_to_id = {}
    bins: List[dict] = []
    linear: List[List[int]] = []
    n_no_coor = 0

    for line, voff_start, voff_end in _iter_lines_voff(vcf_gz_path):
        if not line or line.startswith(b"#"):
            continue
        f = line.split(b"\t", 4)
        chrom = f[0].decode()
        pos = int(f[1]) - 1
        end = pos + len(f[3])
        if chrom not in name_to_id:
            name_to_id[chrom] = len(names)
            names.append(chrom)
            bins.append({})
            linear.append([])
        tid = name_to_id[chrom]
        b = _reg2bin(pos, end)
        chunks = bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        wbeg, wend = pos >> LINEAR_SHIFT, (end - 1) >> LINEAR_SHIFT
        lin = linear[tid]
        while len(lin) <= wend:
            lin.append(0)
        for w in range(wbeg, wend + 1):
            if lin[w] == 0:
                lin[w] = voff_start

    nm_block = b"".join(n.encode() + b"\x00" for n in names)
    out = bytearray(TBI_MAGIC)
    out += struct.pack(
        "<iiiiiiii",
        len(names),
        TBX_VCF,   # format preset
        1,         # col_seq
        2,         # col_beg
        0,         # col_end (derived from REF length for VCF)
        ord("#"),  # meta char
        0,         # lines to skip
        len(nm_block),
    )
    out += nm_block
    for tid in range(len(names)):
        out += struct.pack("<i", len(bins[tid]))
        for b in sorted(bins[tid]):
            chunks = bins[tid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        out += struct.pack("<i", len(linear[tid]))
        prev = 0
        for w in linear[tid]:
            if w == 0:
                w = prev
            prev = w
            out += struct.pack("<Q", w)
    out += struct.pack("<Q", n_no_coor)
    with open(tbi_path, "wb") as fh:
        fh.write(bgzf.compress(bytes(out)))
    return tbi_path


def read_tbi(path: str):
    """Parse a .tbi; returns (names, config dict, bins list, linear list)."""
    data = bgzf.BGZFReader(path).read()
    if data[:4] != TBI_MAGIC:
        raise ValueError("not a TBI file")
    off = 4
    n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm = struct.unpack_from(
        "<iiiiiiii", data, off
    )
    off += 32
    names = [n.decode() for n in data[off : off + l_nm].split(b"\x00") if n]
    off += l_nm
    bins_all, lin_all = [], []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((cb, ce))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins_all.append(bins)
        lin_all.append(lin)
    cfg = dict(format=fmt, col_seq=col_seq, col_beg=col_beg, col_end=col_end,
               meta=meta, skip=skip)
    return names, cfg, bins_all, lin_all


def fetch_region(vcf_gz_path: str, tbi_path: str, chrom: str, beg: int, end: int) -> List[bytes]:
    """Return VCF lines overlapping [beg, end) using the .tbi index."""
    from .bai import reg2bins  # same binning scheme

    names, cfg, bins_all, lin_all = read_tbi(tbi_path)
    if chrom not in names:
        return []
    tid = names.index(chrom)
    lin = lin_all[tid]
    min_off = lin[min(beg >> LINEAR_SHIFT, len(lin) - 1)] if lin else 0
    chunks = []
    for b in reg2bins(beg, end):
        for cb, ce in bins_all[tid].get(b, []):
            if ce > min_off:
                chunks.append((max(cb, min_off), ce))
    chunks.sort()
    rd = bgzf.BGZFReader(vcf_gz_path)
    out = []
    for cb, ce in chunks:
        rd.seek_virtual(cb)
        buf = b""
        while rd.tell_virtual < ce or buf:
            chunk = rd.read(65536) if rd.tell_virtual < ce else b""
            buf += chunk
            while True:
                nl = buf.find(b"\n")
                if nl < 0:
                    break
                line = buf[:nl]
                buf = buf[nl + 1 :]
                f = line.split(b"\t", 4)
                if len(f) >= 4 and f[0].decode() == chrom:
                    p = int(f[1]) - 1
                    if p < end and p + len(f[3]) > beg:
                        out.append(line)
                    elif p >= end:
                        rd.close()
                        return out
            if not chunk:
                break
    rd.close()
    return out
