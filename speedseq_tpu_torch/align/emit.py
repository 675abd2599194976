"""Columnar record emission: device fetch → BAM record columns, no
per-read Python objects.

The reference keeps bwa saturated by running SAM assembly in C inside bwa
(mem_aln2sam) and streaming it through samblaster/sambamba as bytes
(bin/speedseq:438-449).  Round-2's epilogue rebuilt that per read in Python
(HostAlignment/SAMRecord objects) and capped the end-to-end pipeline at
~1/4.5 of the device step.  This module is the columnar replacement: every
per-record quantity (flags, coordinates, tlen, MAPQ, NM, cigars, aux blobs,
seq/qual bytes) is computed as a numpy column over the whole batch, and the
native runtime (csrc/ssq_native.cc) assembles cigar strings, aux blobs, and
encoded records in single C calls.  Rare variable-content records (SA/XA
tags) take tiny per-row loops over just the affected rows.

Output tag deviations from round-2's record path (both closer to bwa):
- MD is not emitted (bwa mem emits no MD; samtools calmd adds it);
  NM is always present on mapped records (kernel traceback NM on TPU,
  vectorized host recount otherwise).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..formats.sam import (
    FDUP, FMREVERSE, FMUNMAP, FPAIRED, FPROPER_PAIR, FREAD1, FREAD2,
    FREVERSE, FSUPPLEMENTARY, FUNMAP,
)
from ..utils.metrics import metrics
from .core import mapq_vec

_ABSENT = np.int32(-2**31)  # shared sentinel with native.build_aux
_BASE_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


# ------------------------------------------------------------ blob helpers

def gather_segments(blob: np.ndarray, off: np.ndarray, idx: np.ndarray):
    """Select variable-length segments idx from (blob, off); returns
    (new_blob, new_off).  Fully vectorized (no per-record loop)."""
    idx = np.asarray(idx, dtype=np.int64)
    lens = (off[idx + 1] - off[idx]).astype(np.int64)
    total = int(lens.sum())
    out_off = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=out_off[1:])
    if total == 0:
        return blob[:0], out_off
    starts_out = out_off[:-1]
    pos = (
        np.arange(total, dtype=np.int64)
        - np.repeat(starts_out, lens)
        + np.repeat(off[idx], lens)
    )
    return blob[pos], out_off


def _concat_blobs(parts: List[Tuple[np.ndarray, np.ndarray]]):
    """Concatenate (blob, off) pairs, rebasing offsets."""
    blobs = [b for b, _ in parts]
    offs = []
    base = 0
    for b, o in parts:
        offs.append(o[:-1] + base if len(o) > 1 else o[:0])
        base += int(o[-1])
    offs.append(np.asarray([base], np.int64))
    blob = np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
    return blob, np.concatenate(offs)


def _cigar_strings(blob: np.ndarray, off: np.ndarray):
    return native.cigar_strings(np.ascontiguousarray(blob, np.uint32),
                                np.ascontiguousarray(off, np.int64))


def _build_aux(nm, as_, xs, mq, rg_idx, rg_blob, rg_off, mc_blob, mc_off,
               extra_blob, extra_off):
    ints = [np.ascontiguousarray(a, np.int32) for a in (nm, as_, xs, mq, rg_idx)]
    bufs = [np.ascontiguousarray(b, np.uint8) for b in (rg_blob, mc_blob, extra_blob)]
    offs = [np.ascontiguousarray(o, np.int64) for o in (rg_off, mc_off, extra_off)]
    return native.build_aux(*ints, bufs[0], offs[0], bufs[1], offs[1],
                            bufs[2], offs[2])


# --------------------------------------------------------- record columns

class RecordColumns:
    """A batch of encoded-ready BAM records as struct-of-arrays (the
    columnar analog of a list of SAMRecord) + the coordinate sort key."""

    __slots__ = ("n", "tid", "pos", "ref_end", "mapq", "flag", "mtid",
                 "mpos", "tlen", "qname_blob", "qname_off", "cigar_blob",
                 "cigar_off", "seq_blob", "qual_blob", "seq_off",
                 "aux_blob", "aux_off")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def sort_keys(self) -> np.ndarray:
        """Packed coordinate key tid<<33|(pos+1)<<1|rev
        (bam_sort.c:1612 semantics; unmapped tid sorts last)."""
        from ..formats.extsort import packed_keys

        return packed_keys(self.tid, self.pos, self.flag.astype(np.int64))

    def to_bam_columns(self):
        return native.BamColumns(
            tid=np.ascontiguousarray(self.tid, np.int32),
            pos=np.ascontiguousarray(self.pos, np.int32),
            ref_end=np.ascontiguousarray(self.ref_end, np.int32),
            mapq=np.ascontiguousarray(self.mapq, np.uint8),
            flag=np.ascontiguousarray(self.flag, np.uint16),
            mtid=np.ascontiguousarray(self.mtid, np.int32),
            mpos=np.ascontiguousarray(self.mpos, np.int32),
            tlen=np.ascontiguousarray(self.tlen, np.int32),
            qname_blob=np.ascontiguousarray(self.qname_blob, np.uint8),
            qname_off=np.ascontiguousarray(self.qname_off, np.int64),
            cigar_blob=np.ascontiguousarray(self.cigar_blob, np.uint32),
            cigar_off=np.ascontiguousarray(self.cigar_off, np.int64),
            seq_blob=np.ascontiguousarray(self.seq_blob, np.uint8),
            qual_blob=np.ascontiguousarray(self.qual_blob, np.uint8),
            seq_off=np.ascontiguousarray(self.seq_off, np.int64),
            aux_blob=np.ascontiguousarray(self.aux_blob, np.uint8),
            aux_off=np.ascontiguousarray(self.aux_off, np.int64),
        )

    def record_sizes(self) -> np.ndarray:
        lq = np.diff(self.qname_off)
        nc = np.diff(self.cigar_off)
        ls = np.diff(self.seq_off)
        la = np.diff(self.aux_off)
        return 4 + 32 + (lq + 1) + 4 * nc + (ls + 1) // 2 + ls + la

    def subset(self, idx: np.ndarray, strip_seq: bool = False) -> "RecordColumns":
        """Row subset; strip_seq empties SEQ/QUAL (the reference's
        gawk '$10="*";$11="*"' side-channel stripping, bin/speedseq:443)."""
        idx = np.asarray(idx, np.int64)
        qb, qo = gather_segments(self.qname_blob, self.qname_off, idx)
        cb, co = gather_segments(self.cigar_blob, self.cigar_off, idx)
        ab, ao = gather_segments(self.aux_blob, self.aux_off, idx)
        if strip_seq:
            sb = self.seq_blob[:0]
            ql = sb
            so = np.zeros(len(idx) + 1, np.int64)
        else:
            sb, so = gather_segments(self.seq_blob, self.seq_off, idx)
            ql, _ = gather_segments(self.qual_blob, self.seq_off, idx)
        return RecordColumns(
            n=len(idx), tid=self.tid[idx], pos=self.pos[idx],
            ref_end=self.ref_end[idx], mapq=self.mapq[idx],
            flag=self.flag[idx], mtid=self.mtid[idx], mpos=self.mpos[idx],
            tlen=self.tlen[idx], qname_blob=qb, qname_off=qo,
            cigar_blob=cb, cigar_off=co, seq_blob=sb, qual_blob=ql,
            seq_off=so, aux_blob=ab, aux_off=ao,
        )

    @classmethod
    def concat(cls, parts: List["RecordColumns"]) -> "RecordColumns":
        parts = [p for p in parts if p.n > 0]
        if not parts:
            return _empty_columns()
        if len(parts) == 1:
            return parts[0]
        kw = {"n": sum(p.n for p in parts)}
        for f in ("tid", "pos", "ref_end", "mapq", "flag", "mtid", "mpos",
                  "tlen"):
            kw[f] = np.concatenate([getattr(p, f) for p in parts])
        for bf, of in (("qname_blob", "qname_off"), ("cigar_blob", "cigar_off"),
                       ("seq_blob", "seq_off"), ("aux_blob", "aux_off")):
            b, o = _concat_blobs([(getattr(p, bf), getattr(p, of))
                                  for p in parts])
            kw[bf], kw[of] = b, o
        # qual shares seq_off
        kw["qual_blob"] = np.concatenate([p.qual_blob for p in parts])
        return cls(**kw)

    def encode(self) -> bytes:
        """Concatenated block_size-prefixed BAM records (native batch
        encode)."""
        return native.bam_encode(self.to_bam_columns())


def _empty_columns() -> RecordColumns:
    z32 = np.zeros(0, np.int32)
    return RecordColumns(
        n=0, tid=z32, pos=z32, ref_end=z32, mapq=np.zeros(0, np.uint8),
        flag=np.zeros(0, np.uint16), mtid=z32, mpos=z32, tlen=z32,
        qname_blob=np.zeros(0, np.uint8), qname_off=np.zeros(1, np.int64),
        cigar_blob=np.zeros(0, np.uint32), cigar_off=np.zeros(1, np.int64),
        seq_blob=np.zeros(0, np.uint8), qual_blob=np.zeros(0, np.uint8),
        seq_off=np.zeros(1, np.int64), aux_blob=np.zeros(0, np.uint8),
        aux_off=np.zeros(1, np.int64),
    )


# ------------------------------------------------------------ end columns

_REF_CONSUME = np.zeros(16, bool)
for _op in (0, 2, 3, 7, 8):
    _REF_CONSUME[_op] = True


class _EndState:
    """All per-end columnar quantities for one fetched batch end."""

    def __init__(self, pe, bb, n, idx, cfg, pac, min_out_score):
        L = bb.seq.shape[1]
        self.n, self.L = n, L
        self.length = bb.length[:n].astype(np.int64)
        self.codes = np.minimum(bb.seq[:n], 4)
        ridx = self.length[:, None] - 1 - np.arange(L)[None, :]
        safe = np.clip(ridx, 0, L - 1)
        rvals = np.take_along_axis(self.codes, safe, axis=1)
        self.rc_codes = np.where(ridx >= 0, np.where(rvals < 4, 3 - rvals, 4),
                                 4).astype(np.uint8)
        self.seq_chars = _BASE_CHARS[self.codes]
        self.rc_chars = _BASE_CHARS[np.minimum(self.rc_codes, 4)]
        self.qual_raw = np.minimum(bb.qual[:n], 93).astype(np.uint8)
        self.rq_raw = np.where(ridx >= 0,
                               np.take_along_axis(self.qual_raw, safe, axis=1),
                               0).astype(np.uint8)

        score = np.asarray(pe.score[:n], np.int64)     # (n, S)
        self.score = score
        self.gpos = np.asarray(pe.pos[:n], np.int64)
        self.grend = np.asarray(pe.rend_pos[:n], np.int64)
        self.strand = np.asarray(pe.strand[:n], np.int64)
        self.qbeg = np.asarray(pe.qbeg[:n], np.int64)
        self.qend = np.asarray(pe.qend[:n], np.int64)
        self.ops = np.asarray(pe.cigar_ops[:n], np.int64)    # (n, S, M)
        self.lens = np.asarray(pe.cigar_len[:n], np.int64)
        self.n_ops = np.asarray(pe.n_ops[:n], np.int64)
        self.knm = np.asarray(pe.nm[:n], np.int64)
        self.sub = np.asarray(pe.sub[:n], np.int64)
        self.sub_n = np.asarray(pe.sub_n[:n], np.int64)

        self.aligned = score[:, 0] >= min_out_score
        sub_full = np.zeros_like(score)
        sub_full[:, 0] = self.sub
        sub_n_full = np.zeros_like(score)
        sub_n_full[:, 0] = self.sub_n
        self.mapq = mapq_vec(score, sub_full, sub_n_full, self.length,
                             cfg.min_seed_len)

        # genome → (tid, chrom pos)
        bounds = np.asarray(idx.offsets + [idx.l_pac], np.int64)
        self.tid = (np.searchsorted(bounds, self.gpos, side="right") - 1)
        self.cpos = self.gpos - bounds[np.clip(self.tid, 0, len(bounds) - 2)]

        # per-slot cigar grids [lead S][kernel ops][tail S]
        M = self.ops.shape[2]
        km = ((np.arange(M)[None, None, :] < self.n_ops[..., None])
              & (self.lens > 0))
        grid = np.zeros((n, score.shape[1], M + 2), np.uint32)
        grid[:, :, 1:M + 1] = np.where(
            km, (self.lens.astype(np.int64) << 4) | self.ops, 0
        ).astype(np.uint32)
        lead = self.qbeg
        tail = self.length[:, None] - self.qend
        grid[:, :, 0] = np.where(lead > 0, (lead << 4) | 4, 0).astype(np.uint32)
        grid[:, :, M + 1] = np.where(tail > 0, (tail << 4) | 4, 0).astype(np.uint32)
        self.cig_grid = grid
        refc = _REF_CONSUME[np.clip(self.ops, 0, 15)]
        self.reflen = np.where(km & refc, self.lens, 0).sum(axis=2)

        # NM per slot: kernel traceback value, else vectorized host recount
        self.nm = self._host_nm(pac)

        # unclipped 5' signature position (samblaster dup key)
        lead0 = self.qbeg[:, 0]
        tail0 = self.length - self.qend[:, 0]
        self.p5 = np.where(
            self.strand[:, 0] == 0, self.gpos[:, 0] - lead0,
            self.grend[:, 0] + tail0)
        self.p5 = np.where(self.aligned, self.p5, -1)

    def _host_nm(self, pac) -> np.ndarray:
        """(n, S) NM: kernel value where provided, else host recount.
        Pure-M rows (the overwhelming majority) count mismatches with one
        vectorized gather against the forward reference; indel rows walk
        the cigar per row (rare)."""
        n, S = self.score.shape
        nm = self.knm.copy()
        need = (nm < 0) & (self.score > 0)
        if not need.any():
            return np.maximum(nm, 0)
        L = self.L
        t = np.arange(L, dtype=np.int64)
        for k in range(S):
            rows = np.nonzero(need[:, k])[0]
            if len(rows) == 0:
                continue
            q = np.where(self.strand[rows, k:k + 1] == 1,
                         self.rc_codes[rows], self.codes[rows]).astype(np.int64)
            qb, qe = self.qbeg[rows, k], self.qend[rows, k]
            span = qe - qb
            qg = np.take_along_axis(q, np.clip(qb[:, None] + t[None, :],
                                               0, L - 1), axis=1)
            ridx = np.clip(self.gpos[rows, k, None] + t[None, :],
                           0, len(pac) - 1)
            r = pac[ridx].astype(np.int64)
            mm = (((qg != r) | (qg >= 4)) & (t[None, :] < span[:, None])).sum(1)
            indel = np.where(
                (self.ops[rows, k] == 1) | (self.ops[rows, k] == 2),
                np.where(np.arange(self.ops.shape[2])[None, :]
                         < self.n_ops[rows, k, None], self.lens[rows, k], 0),
                0).sum(1)
            pure = (self.n_ops[rows, k] == 1) & (self.ops[rows, k, 0] == 0)
            nm[rows, k] = np.where(pure, mm, -1)
            # slow path: walk indel cigars row by row
            for j in np.nonzero(~pure)[0]:
                i = rows[j]
                qi = int(self.qbeg[i, k])
                ri = int(self.gpos[i, k])
                qrow = q[j]
                e = 0
                for c in range(int(self.n_ops[i, k])):
                    op, ln = int(self.ops[i, k, c]), int(self.lens[i, k, c])
                    if op == 0:
                        qs = qrow[qi:qi + ln]
                        rs = pac[ri:ri + ln].astype(np.int64)
                        e += int(((qs != rs) | (qs >= 4)).sum())
                        qi += ln
                        ri += ln
                    elif op == 1:
                        e += ln
                        qi += ln
                    elif op == 2:
                        e += ln
                        ri += ln
                nm[i, k] = e
        return np.maximum(nm, 0)

    def slot_cigar(self, k: int, rows: np.ndarray):
        """(blob u32, off) of final cigars (with clips) for rows, slot k."""
        g = self.cig_grid[rows, k]             # (m, M+2)
        valid = g != 0
        lens = valid.sum(axis=1).astype(np.int64)
        off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        return g[valid], off

    def seq_cols(self, rows: np.ndarray, rc: np.ndarray):
        """(seq_blob ASCII, qual_blob raw-phred, off) for rows with
        per-row reverse-complement selection."""
        sel = np.where(rc[:, None], self.rc_chars[rows], self.seq_chars[rows])
        selq = np.where(rc[:, None], self.rq_raw[rows], self.qual_raw[rows])
        lens = self.length[rows]
        m = np.arange(self.L)[None, :] < lens[:, None]
        off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        return sel[m], selq[m], off


def _orig_frame_vec(qb, qe, strand, qlen):
    ob = np.where(strand == 1, qlen - qe, qb)
    oe = np.where(strand == 1, qlen - qb, qe)
    return ob, oe


def _sa_fragment(name: str, pos1: int, strand: int, cig: str, mapq: int,
                 nm: int) -> bytes:
    return (b"SAZ"
            + f"{name},{pos1},{'-' if strand else '+'},{cig},{mapq},{nm};".encode()
            + b"\x00")


_MAX_XA_HITS = 5   # bwa mem max XA entries per read [external knowledge]


def build_batch_records(
    ends: List,                      # [PackedEnd] (1 or 2)
    batches: List,                   # [ReadBatch] sliced views
    idx,                             # BWAIndex
    distro,                          # InsertDistro
    cfg,                             # AlignConfig
    marker,                          # StreamDupMarker
    lib_of_rg: Dict[str, int],
    min_out_score: int = 30,
    xas: Optional[List] = None,      # [PackedXA] compacted extra XA lanes
) -> Dict[str, RecordColumns]:
    """One batch: device fetch → {bam, splitters, discordants} columns.

    Record order within the batch is [end1 primaries, end2 primaries,
    end1 supplementaries, end2 supplementaries]; the external sorter's
    stable coordinate sort makes intra-batch order irrelevant beyond
    tie-breaking, which is consistent across runs/device counts."""
    n = batches[0].n
    if n == 0:
        e = _empty_columns()
        return {"bam": e, "splitters": e, "discordants": e}
    paired = len(ends) == 2
    pac = idx.pac
    es = [
        _EndState(pe, bb, n, idx, cfg, pac, min_out_score)
        for pe, bb in zip(ends, batches)
    ]

    # ---- template-level metadata -------------------------------------
    names = batches[0].names[:n]
    name_lens = np.fromiter((len(s) for s in names), np.int64, count=n)
    qname_off_t = np.zeros(n + 1, np.int64)
    np.cumsum(name_lens, out=qname_off_t[1:])
    qname_blob_t = np.frombuffer("".join(names).encode(), np.uint8)

    comments = batches[0].comments
    rgs = [
        (comments[i][3:] if i < len(comments)
         and comments[i].startswith("RG:") else "") or cfg.rg_id
        for i in range(n)
    ]
    rg_map: Dict[str, int] = {}
    rg_idx_t = np.empty(n, np.int32)
    for i, rg in enumerate(rgs):
        rg_idx_t[i] = rg_map.setdefault(rg, len(rg_map))
    rg_strs = sorted(rg_map, key=rg_map.get)
    rg_off = np.zeros(len(rg_strs) + 1, np.int64)
    np.cumsum([len(s) for s in rg_strs], out=rg_off[1:])
    rg_blob = np.frombuffer("".join(rg_strs).encode(), np.uint8)
    lib = np.asarray([lib_of_rg.get(rg, 0) for rg in rgs], np.int64)

    # ---- pair logic ----------------------------------------------------
    if paired:
        e1, e2 = es
        both = e1.aligned & e2.aligned
        same_tid = e1.tid[:, 0] == e2.tid[:, 0]
        left = np.minimum(e1.gpos[:, 0], e2.gpos[:, 0])
        right = np.maximum(e1.grend[:, 0], e2.grend[:, 0])
        isize = right - left
        fwd_first = np.where(e1.gpos[:, 0] <= e2.gpos[:, 0],
                             e1.strand[:, 0] == 0, e2.strand[:, 0] == 0)
        proper = (both & same_tid & (e1.strand[:, 0] != e2.strand[:, 0])
                  & fwd_first & (isize >= distro.low) & (isize <= distro.high))
        discordant = both & ~proper
        with metrics.timer("align.emit.markdup"):
            dup = marker.mark_batch(
                e1.tid[:, 0], e1.p5, e1.strand[:, 0], e1.aligned,
                e2.tid[:, 0], e2.p5, e2.strand[:, 0], e2.aligned, lib=lib)
        dup &= e1.aligned | e2.aligned
    else:
        e1 = es[0]
        both = np.zeros(n, bool)
        proper = np.zeros(n, bool)
        discordant = np.zeros(n, bool)
        none = np.full(n, -1, np.int64)
        with metrics.timer("align.emit.markdup"):
            dup = marker.mark_batch(
                e1.tid[:, 0], e1.p5, e1.strand[:, 0], e1.aligned,
                none, none, none, np.zeros(n, bool), lib=lib)
        dup &= e1.aligned

    all_rows = np.arange(n, dtype=np.int64)
    prim_sections: List[RecordColumns] = []
    supp_sections: List[RecordColumns] = []
    prim_split_masks: List[np.ndarray] = []
    prim_disc_masks: List[np.ndarray] = []
    prim_dup_masks: List[np.ndarray] = []
    supp_dup_masks: List[np.ndarray] = []

    for w, e in enumerate(es):
        mate = es[1 - w] if paired else None
        ok = e.aligned
        mok = mate.aligned if mate is not None else np.zeros(n, bool)

        # -- supplementary / XA detection (slot 1) ----------------------
        supp_scored = (e.score[:, 1] >= min_out_score) & (e.gpos[:, 1] >= 0)
        ref_disjoint = ((e.grend[:, 1] <= e.gpos[:, 0])
                        | (e.gpos[:, 1] >= e.grend[:, 0]))
        has_supp = ok & supp_scored & ref_disjoint
        pb, pe_ = _orig_frame_vec(e.qbeg[:, 0], e.qend[:, 0], e.strand[:, 0],
                                  e.length)
        sb, se = _orig_frame_vec(e.qbeg[:, 1], e.qend[:, 1], e.strand[:, 1],
                                 e.length)
        ov = np.maximum(0, np.minimum(pe_, se) - np.maximum(pb, sb))
        nno = cfg.min_non_overlap
        split_q = (((pe_ - pb) - ov >= nno) & ((se - sb) - ov >= nno))
        has_split = has_supp & split_q
        has_xa = (has_supp & ~split_q
                  & (e.score[:, 1] >= 0.8 * e.score[:, 0]))

        # -- flags -------------------------------------------------------
        flag = np.zeros(n, np.int64)
        if paired:
            flag |= FPAIRED | (FREAD1 if w == 0 else FREAD2)
            flag |= np.where(proper, FPROPER_PAIR, 0)
            flag |= np.where(~mok, FMUNMAP, 0)
            flag |= np.where(mok & (mate.strand[:, 0] == 1), FMREVERSE, 0)
        flag |= np.where(~ok, FUNMAP, 0)
        flag |= np.where(ok & (e.strand[:, 0] == 1), FREVERSE, 0)
        flag |= np.where(dup, FDUP, 0)

        # -- coordinates ---------------------------------------------------
        rec_tid = np.where(ok, e.tid[:, 0],
                           np.where(mok, mate.tid[:, 0] if mate is not None
                                    else -1, -1)).astype(np.int32)
        rec_pos = np.where(ok, e.cpos[:, 0],
                           np.where(mok, mate.cpos[:, 0] if mate is not None
                                    else -1, -1)).astype(np.int32)
        if paired:
            mtid = np.where(mok, mate.tid[:, 0],
                            np.where(ok, rec_tid, -1)).astype(np.int32)
            mpos = np.where(mok, mate.cpos[:, 0],
                            np.where(ok, rec_pos, -1)).astype(np.int32)
            tl_mag = right - left
            tl_pos = (e.gpos[:, 0] < mate.gpos[:, 0]) | (
                (e.gpos[:, 0] == mate.gpos[:, 0]) & (w == 0))
            tlen = np.where(both & same_tid,
                            np.where(tl_pos, tl_mag, -tl_mag), 0
                            ).astype(np.int32)
        else:
            mtid = np.full(n, -1, np.int32)
            mpos = np.full(n, -1, np.int32)
            tlen = np.zeros(n, np.int32)

        ref_end = np.where(
            (rec_tid >= 0) & (rec_pos >= 0),
            rec_pos + np.where(ok & (e.reflen[:, 0] > 0), e.reflen[:, 0], 1),
            np.where(rec_pos >= 0, rec_pos + 1, 0)).astype(np.int32)

        # -- cigar (empty for unmapped) ------------------------------------
        cig_rows = e.cig_grid[:, 0].copy()
        cig_rows[~ok] = 0
        valid = cig_rows != 0
        clens = valid.sum(axis=1).astype(np.int64)
        cig_off = np.zeros(n + 1, np.int64)
        np.cumsum(clens, out=cig_off[1:])
        cig_blob = cig_rows[valid]

        # -- seq/qual -------------------------------------------------------
        use_rc = ok & (e.strand[:, 0] == 1)
        seq_blob, qual_blob, seq_off = e.seq_cols(all_rows, use_rc)

        # -- aux --------------------------------------------------------------
        nm_col = np.where(ok, e.nm[:, 0], _ABSENT).astype(np.int32)
        as_col = np.where(ok, e.score[:, 0], _ABSENT).astype(np.int32)
        xs_col = np.where(ok, e.sub, _ABSENT).astype(np.int32)
        if paired:
            mq_col = np.where(mok, mate.mapq[:, 0], _ABSENT).astype(np.int32)
            mc_grid = mate.cig_grid[:, 0].copy()
            mc_grid[~mok] = 0
            mvalid = mc_grid != 0
            mlens = mvalid.sum(axis=1).astype(np.int64)
            mcig_off = np.zeros(n + 1, np.int64)
            np.cumsum(mlens, out=mcig_off[1:])
            mc_blob_s, mc_off = _cigar_strings(mc_grid[mvalid], mcig_off)
        else:
            mq_col = np.full(n, _ABSENT, np.int32)
            mc_blob_s = np.zeros(0, np.uint8)
            mc_off = np.zeros(n + 1, np.int64)

        # SA / XA extras (rare rows only)
        extra_parts: Dict[int, bytes] = {}
        sa_rows = np.nonzero(has_split)[0]
        xa_rows = np.nonzero(has_xa)[0]
        # per-read XA entry lists: slot-1 secondary + compacted extra
        # lanes (bwa emits up to _MAX_XA_HITS placements, best first)
        xa_entries: Dict[int, List[Tuple[int, str]]] = {}
        if len(sa_rows) or len(xa_rows):
            both_rows = np.concatenate([sa_rows, xa_rows])
            cb1, co1 = e.slot_cigar(1, both_rows)
            cstr_blob, cstr_off = _cigar_strings(cb1, co1)
            cstrs = {
                int(r): cstr_blob[cstr_off[j]:cstr_off[j + 1]].tobytes().decode()
                for j, r in enumerate(both_rows)
            }
            for r in sa_rows:
                r = int(r)
                extra_parts[r] = _sa_fragment(
                    idx.names[int(e.tid[r, 1])], int(e.cpos[r, 1]) + 1,
                    int(e.strand[r, 1]), cstrs[r], int(e.mapq[r, 1]),
                    int(e.nm[r, 1]))
            for r in xa_rows:
                r = int(r)
                xa_entries.setdefault(r, []).append((
                    int(e.score[r, 1]),
                    f"{idx.names[int(e.tid[r, 1])]},"
                    f"{'-' if e.strand[r, 1] else '+'}{int(e.cpos[r, 1]) + 1},"
                    f"{cstrs[r]},{int(e.nm[r, 1])};",
                ))
        xa = xas[w] if xas is not None and w < len(xas) else None
        if xa is not None:
            lanes = np.nonzero(
                (np.asarray(xa.read_idx) >= 0)
                & (np.asarray(xa.read_idx) < n)
            )[0]
            if len(lanes):
                bounds = np.asarray(idx.offsets + [idx.l_pac], np.int64)
                lpos = np.asarray(xa.pos)[lanes].astype(np.int64)
                ltid = np.searchsorted(bounds, lpos, side="right") - 1
                lcpos = lpos - bounds[np.clip(ltid, 0, len(bounds) - 2)]
                lrd = np.asarray(xa.read_idx)[lanes].astype(np.int64)
                # cigars with clips for each lane
                M = xa.cigar_ops.shape[1]
                km = ((np.arange(M)[None, :]
                       < np.asarray(xa.n_ops)[lanes, None])
                      & (np.asarray(xa.cigar_len)[lanes] > 0))
                grid = np.zeros((len(lanes), M + 2), np.uint32)
                grid[:, 1:M + 1] = np.where(
                    km,
                    (np.asarray(xa.cigar_len)[lanes].astype(np.int64) << 4)
                    | np.asarray(xa.cigar_ops)[lanes], 0).astype(np.uint32)
                lead = np.asarray(xa.qbeg)[lanes].astype(np.int64)
                tail = e.length[lrd] - np.asarray(
                    xa.qend)[lanes].astype(np.int64)
                grid[:, 0] = np.where(
                    lead > 0, (lead << 4) | 4, 0).astype(np.uint32)
                grid[:, M + 1] = np.where(
                    tail > 0, (tail << 4) | 4, 0).astype(np.uint32)
                gvalid = grid != 0
                glens = gvalid.sum(axis=1).astype(np.int64)
                goff = np.zeros(len(lanes) + 1, np.int64)
                np.cumsum(glens, out=goff[1:])
                gs_blob, gs_off = _cigar_strings(grid[gvalid], goff)
                for j in range(len(lanes)):
                    r = int(lrd[j])
                    if not ok[r]:
                        continue
                    # a lane duplicating the primary placement is skipped
                    if (int(ltid[j]) == int(e.tid[r, 0])
                            and int(lcpos[j]) == int(e.cpos[r, 0])):
                        continue
                    cig = gs_blob[gs_off[j]:gs_off[j + 1]].tobytes().decode()
                    xa_entries.setdefault(r, []).append((
                        int(np.asarray(xa.score)[lanes[j]]),
                        f"{idx.names[int(ltid[j])]},"
                        f"{'-' if np.asarray(xa.strand)[lanes[j]] else '+'}"
                        f"{int(lcpos[j]) + 1},{cig},"
                        f"{max(0, int(np.asarray(xa.nm)[lanes[j]]))};",
                    ))
        for r, entries in xa_entries.items():
            entries.sort(key=lambda t: -t[0])
            seen = set()
            frags = []
            for _s, f in entries:
                if f not in seen:
                    seen.add(f)
                    frags.append(f)
                if len(frags) >= _MAX_XA_HITS:
                    break
            extra_parts[r] = (
                extra_parts.get(r, b"")
                + b"XAZ" + "".join(frags).encode() + b"\x00")
        extra_off = np.zeros(n + 1, np.int64)
        if extra_parts:
            elens = np.zeros(n, np.int64)
            for r, bts in extra_parts.items():
                elens[r] = len(bts)
            np.cumsum(elens, out=extra_off[1:])
            eb = bytearray(int(extra_off[-1]))
            for r, bts in extra_parts.items():
                eb[int(extra_off[r]):int(extra_off[r + 1])] = bts
            extra_blob = np.frombuffer(bytes(eb), np.uint8)
        else:
            extra_blob = np.zeros(0, np.uint8)

        aux_blob, aux_off = _build_aux(
            nm_col, as_col, xs_col, mq_col, rg_idx_t, rg_blob, rg_off,
            mc_blob_s, mc_off, extra_blob, extra_off)

        prim = RecordColumns(
            n=n, tid=rec_tid, pos=rec_pos, ref_end=ref_end,
            mapq=np.where(ok, e.mapq[:, 0], 0).astype(np.uint8),
            flag=flag.astype(np.uint16), mtid=mtid, mpos=mpos, tlen=tlen,
            qname_blob=qname_blob_t, qname_off=qname_off_t,
            cigar_blob=cig_blob, cigar_off=cig_off,
            seq_blob=seq_blob, qual_blob=qual_blob, seq_off=seq_off,
            aux_blob=aux_blob, aux_off=aux_off,
        )
        prim_sections.append(prim)
        prim_split_masks.append(has_split)
        prim_disc_masks.append(discordant)
        prim_dup_masks.append(dup)

        # -- supplementary records (split rows only) ------------------------
        if len(sa_rows):
            sr = sa_rows.astype(np.int64)
            m = len(sr)
            sflag = flag[sr] | FSUPPLEMENTARY
            sflag = np.where(e.strand[sr, 1] == 1, sflag | FREVERSE,
                             sflag & ~np.int64(FREVERSE))
            stid = e.tid[sr, 1].astype(np.int32)
            spos = e.cpos[sr, 1].astype(np.int32)
            scig_blob, scig_off = e.slot_cigar(1, sr)
            sref_end = (spos + np.maximum(e.reflen[sr, 1], 1)).astype(np.int32)
            sseq, squal, ssoff = e.seq_cols(sr, e.strand[sr, 1] == 1)
            # SA back-reference to the primary piece
            pcb, pco = e.slot_cigar(0, sr)
            pstr_blob, pstr_off = _cigar_strings(pcb, pco)
            sxb = bytearray()
            sx_off = np.zeros(m + 1, np.int64)
            for j, r in enumerate(sr):
                r = int(r)
                frag = _sa_fragment(
                    idx.names[int(e.tid[r, 0])], int(e.cpos[r, 0]) + 1,
                    int(e.strand[r, 0]),
                    pstr_blob[pstr_off[j]:pstr_off[j + 1]].tobytes().decode(),
                    int(e.mapq[r, 0]), int(e.nm[r, 0]))
                sxb += frag
                sx_off[j + 1] = len(sxb)
            s_aux, s_aux_off = _build_aux(
                e.nm[sr, 1].astype(np.int32), e.score[sr, 1].astype(np.int32),
                np.full(m, _ABSENT, np.int32), np.full(m, _ABSENT, np.int32),
                rg_idx_t[sr], rg_blob, rg_off,
                np.zeros(0, np.uint8), np.zeros(m + 1, np.int64),
                np.frombuffer(bytes(sxb), np.uint8), sx_off)
            sqb, sqo = gather_segments(qname_blob_t, qname_off_t, sr)
            supp = RecordColumns(
                n=m, tid=stid, pos=spos, ref_end=sref_end,
                mapq=e.mapq[sr, 1].astype(np.uint8),
                flag=sflag.astype(np.uint16),
                mtid=mtid[sr], mpos=mpos[sr],
                tlen=np.zeros(m, np.int32),
                qname_blob=sqb, qname_off=sqo,
                cigar_blob=scig_blob, cigar_off=scig_off,
                seq_blob=sseq, qual_blob=squal, seq_off=ssoff,
                aux_blob=s_aux, aux_off=s_aux_off,
            )
            supp_sections.append(supp)
            supp_dup_masks.append(dup[sr])

    # ---- assemble the three streams ------------------------------------
    main = RecordColumns.concat(prim_sections + supp_sections)

    with metrics.timer("align.emit.side"):
        dup_ok_masks = [
            (~d) | cfg.include_dups_in_side for d in prim_dup_masks
        ]
        split_gate = cfg.max_split_count >= 2
        # splitters: primary rows with a split + all supp rows (dup-gated)
        spl_parts = []
        if split_gate:
            for sec, hs, dok in zip(prim_sections, prim_split_masks,
                                    dup_ok_masks):
                rows = np.nonzero(hs & dok)[0]
                if len(rows):
                    spl_parts.append(sec.subset(rows, strip_seq=True))
            for sec, d in zip(supp_sections, supp_dup_masks):
                rows = np.nonzero((~d) | cfg.include_dups_in_side)[0]
                if len(rows):
                    spl_parts.append(sec.subset(rows, strip_seq=True))
        splitters = RecordColumns.concat(spl_parts)

        disc_parts = []
        for sec, dm, dok in zip(prim_sections, prim_disc_masks, dup_ok_masks):
            rows = np.nonzero(dm & dok)[0]
            if len(rows):
                disc_parts.append(sec.subset(rows, strip_seq=True))
        discordants = RecordColumns.concat(disc_parts)

    return {"bam": main, "splitters": splitters, "discordants": discordants}
