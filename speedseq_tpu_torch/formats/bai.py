"""BAI index builder/reader (htslib hts_idx equivalent).

Contract: src/samtools-1.3.1/htslib-1.3.1/hts.c:1192-1314 (hts_idx_init/
push/save) with BAI = 14-bit minimum shift, 5 levels (hts.c:1622), 16 KiB
linear index windows, pseudo-bin 37450 carrying the unmapped-placed chunk
and mapped/unmapped counts.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .sam import FUNMAP

BAI_MAGIC = b"BAI\x01"
PSEUDO_BIN = 37450  # bin for meta chunk (hts.c idx meta)
LINEAR_SHIFT = 14   # 16 KiB windows


@dataclass
class _RefIndex:
    bins: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    linear: List[int] = field(default_factory=list)
    n_mapped: int = 0
    n_unmapped: int = 0
    off_beg: int = -1
    off_end: int = -1


def _reg2bin_vec(beg, end):
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        m = ~done & ((beg >> shift) == (e >> shift))
        out[m] = offset + (beg[m] >> shift)
        done |= m
    return out


def build_bai(bam_path: str, bai_path: Optional[str] = None) -> str:
    """Build a .bai for a coordinate-sorted BAM (sambamba/samtools index
    equivalent; invoked by the reference at bin/speedseq:491-495).

    Columnar: one BGZF block-table scan + one record decode, then
    per-record virtual offsets by searchsorted and bins/ref-ends as
    columns; only the per-record chunk-merge walk stays Python (plain int
    ops).  The offsets are those a BGZFReader reports record by record."""
    from ..sv.columnar import cigar_ref_lengths, read_bam_columns, record_sizes

    bai_path = bai_path or bam_path + ".bai"
    with open(bam_path, "rb") as fh:
        data = fh.read()
    co, isz = native.bgzf_block_table(data)
    ublock = np.zeros(len(isz) + 1, np.int64)
    np.cumsum(isz, out=ublock[1:])
    refs_hdr, cols, blob = read_bam_columns(bam_path, with_blob=True)
    n_ref = len(refs_hdr)
    H = ublock[-1] - len(blob)          # header bytes in the plain stream
    sizes = record_sizes(cols)
    starts = np.zeros(cols.n, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    starts += H
    ends_b = starts + sizes
    # reader-identical virtual offsets: the block containing byte-1 keeps
    # records at block boundaries addressed as (prev block, block_len),
    # exactly like BGZFReader.tell_virtual after a full-block read
    bb = np.searchsorted(ublock, starts - 1, side="right") - 1
    voff_beg = (co[bb] << 16) | (starts - ublock[bb])
    be = np.searchsorted(ublock, ends_b - 1, side="right") - 1
    voff_end = (co[be] << 16) | (ends_b - ublock[be])

    rl = cigar_ref_lengths(cols)
    pos = cols.pos.astype(np.int64)
    end = pos + np.maximum(rl, 1)
    tid = cols.tid.astype(np.int64)
    mapped = (cols.flag.astype(np.int64) & FUNMAP) == 0
    placed = (tid >= 0) & (pos >= 0)
    bins = _reg2bin_vec(pos, end)

    refs = [_RefIndex() for _ in range(n_ref)]
    n_no_coor = int((~placed).sum())
    pi = np.nonzero(placed)[0]
    tid_l = tid[pi].tolist()
    pos_l = pos[pi].tolist()
    end_l = end[pi].tolist()
    vb_l = voff_beg[pi].tolist()
    ve_l = voff_end[pi].tolist()
    bin_l = bins[pi].tolist()
    map_l = mapped[pi].tolist()
    for t, p, e, vb, ve, b, m in zip(
        tid_l, pos_l, end_l, vb_l, ve_l, bin_l, map_l
    ):
        ri = refs[t]
        chunks = ri.bins.setdefault(b, [])
        if chunks and chunks[-1][1] == vb:
            chunks[-1] = (chunks[-1][0], ve)
        else:
            chunks.append((vb, ve))
        wbeg, wend = p >> LINEAR_SHIFT, (e - 1) >> LINEAR_SHIFT
        lin = ri.linear
        if len(lin) <= wend:
            lin.extend([0] * (wend + 1 - len(lin)))
        for w in range(wbeg, wend + 1):
            if lin[w] == 0:
                lin[w] = vb
        if ri.off_beg < 0:
            ri.off_beg = vb
        ri.off_end = ve
        if m:
            ri.n_mapped += 1
        else:
            ri.n_unmapped += 1
    out = bytearray(BAI_MAGIC + struct.pack("<i", n_ref))
    for ri in refs:
        n_bin = len(ri.bins) + (1 if ri.n_mapped + ri.n_unmapped > 0 else 0)
        out += struct.pack("<i", n_bin)
        for b in sorted(ri.bins):
            chunks = ri.bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if ri.n_mapped + ri.n_unmapped > 0:
            out += struct.pack("<Ii", PSEUDO_BIN, 2)
            out += struct.pack("<QQ", ri.off_beg, ri.off_end)
            out += struct.pack("<QQ", ri.n_mapped, ri.n_unmapped)
        out += struct.pack("<i", len(ri.linear))
        prev = 0
        for w in ri.linear:
            if w == 0:
                w = prev
            prev = w
            out += struct.pack("<Q", w)
    out += struct.pack("<Q", n_no_coor)
    with open(bai_path, "wb") as fh:
        fh.write(out)
    return bai_path


@dataclass
class BAIIndex:
    bins: List[Dict[int, List[Tuple[int, int]]]]
    linear: List[List[int]]
    n_no_coor: int = 0


def read_bai(path: str) -> BAIIndex:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI file")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    bins_all, lin_all = [], []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
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
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return BAIIndex(bins_all, lin_all, n_no_coor)


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (hts_itr_query bin walk)."""
    out = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def query_chunks(idx: BAIIndex, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
    """Candidate (voff_beg, voff_end) chunks overlapping a region."""
    if tid < 0 or tid >= len(idx.bins):
        return []
    bins = idx.bins[tid]
    lin = idx.linear[tid]
    min_off = 0
    w = beg >> LINEAR_SHIFT
    if lin:
        min_off = lin[min(w, len(lin) - 1)]
    chunks = []
    for b in reg2bins(beg, end):
        if b == PSEUDO_BIN:
            continue
        for cb, ce in bins.get(b, []):
            if ce > min_off:
                chunks.append((max(cb, min_off), ce))
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    return merged


def fetch_raw(rd, idx: BAIIndex, tid: int, beg: int, end: int) -> bytes:
    """Region fetch as block_size-prefixed raw record bytes — the native
    bam_decode input (hts_itr_query equivalent).  ``rd`` is a
    formats.bam.BAMReader.  Whole chunk byte-ranges are read in bulk
    (BGZFReader.read_to) — no per-record loop; chunks are bin-granular,
    so the caller must columnarly re-filter tid / pos-overlap after
    decode (build_pileup_columns and the sv columnar paths do)."""
    parts = []
    for cb, ce in query_chunks(idx, tid, max(0, beg), end):
        rd.seek_virtual(cb)
        parts.append(rd._r.read_to(ce))
    return b"".join(parts)
