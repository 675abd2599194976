"""Pileup construction: BAM records → per-window count arrays.

Vectorized host-side projection of alignments onto reference coordinates
(the role of FreeBayes' pileup traversal [external knowledge]); produces
the count tensors the candidate generator and the device GL kernel
consume.

Storage is span-compact: each read stores only its covered window span
(reads cover ~read_len bases of a 100 kb window), so memory is
O(total aligned bases), not O(reads × window) — the dense per-read
projection matrix would cost ~3 GB per 100 kb window at 30X WGS.
Column lookups (`col`) gather one window offset across all covering
reads with pure numpy indexing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..formats.sam import FDUP, FSECONDARY, FSUPPLEMENTARY, FUNMAP, SAMRecord
from ..formats.fasta import encode_bases


@dataclass
class ReadEvent:
    """One indel event observed in a read."""

    pos: int          # ref pos (0-based); for ins: base before insertion
    is_ins: bool
    length: int
    seq: str          # inserted sequence (ins only)
    read_idx: int


@dataclass
class WindowPileup:
    """Per-window pileup tensors.

    base_counts:  (L, 5) int32 — A/C/G/T/N counts per ref offset
    qual_sums:    (L, 5) int32 — summed base qualities
    strand_counts:(L, 5, 2)    — per strand
    depth:        (L,) int32
    reads:        list of (record, sample_idx) kept for per-site support

    Span-compact per-read projection: read i covers window offsets
    [rstart[i], rend[i]); its bases/quals/read-positions live at
    flat_*[base_idx[i] : base_idx[i] + rend[i] - rstart[i]].
    """

    start: int
    end: int
    base_counts: np.ndarray
    qual_sums: np.ndarray
    strand_counts: np.ndarray
    depth: np.ndarray
    reads: List[Tuple[SAMRecord, int]]
    rstart: np.ndarray            # (R,) int32 window offsets
    rend: np.ndarray              # (R,) int32
    base_idx: np.ndarray          # (R,) int64 offsets into flat arrays
    flat_proj: np.ndarray         # int8 base code or -1
    flat_qual: np.ndarray         # int8
    flat_rpos: np.ndarray         # int32 offset in read or -1
    events: List[ReadEvent] = field(default_factory=list)
    # columnar per-read metadata (filled by both constructors; the caller
    # and the haplotype scorer consume these instead of SAMRecord objects)
    sample_of_read: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    strand: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int8))        # (R,) 1 = rev
    read_pos: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))       # abs ref pos
    read_len: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))       # seq length
    read_seq: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.uint8))  # (R, Lmax) codes
    # lazy col() acceleration (built on first column gather)
    _srt: Optional[np.ndarray] = field(default=None, repr=False)
    _rs_sorted: Optional[np.ndarray] = field(default=None, repr=False)
    _span_max: int = field(default=0, repr=False)

    def col(self, off: int):
        """Gather window offset `off` across all reads.

        Returns (proj, qual, rpos) each (R,): base code / qual /
        read-position, with -1 / 0 / -1 for reads not covering `off`.

        Candidate reads come from a one-time rstart sort + searchsorted
        window (reads covering `off` start within span_max of it), so a
        column gather touches O(depth) reads, not all R of the window —
        col() runs once per locus/anchor and the full-R boolean masks
        were ~0.3 s of a somatic slice run."""
        R = len(self.rstart)
        proj = np.full(R, -1, np.int8)
        qual = np.zeros(R, np.int8)
        rpos = np.full(R, -1, np.int32)
        if R == 0:
            return proj, qual, rpos
        if self._srt is None:
            self._srt = np.argsort(self.rstart, kind="stable")
            self._rs_sorted = self.rstart[self._srt]
            self._span_max = int((self.rend - self.rstart).max())
        i0 = np.searchsorted(self._rs_sorted, off - self._span_max, "left")
        i1 = np.searchsorted(self._rs_sorted, off, "right")
        cand = self._srt[i0:i1]
        sel = cand[off < self.rend[cand]]
        if len(sel):
            idx = self.base_idx[sel] + (off - self.rstart[sel])
            proj[sel] = self.flat_proj[idx]
            qual[sel] = self.flat_qual[idx]
            rpos[sel] = self.flat_rpos[idx]
        return proj, qual, rpos

    def covers(self, lo: int, hi: int) -> np.ndarray:
        """(R,) bool — read span fully covers window offsets [lo, hi)."""
        return (self.rstart <= lo) & (self.rend >= hi)


SKIP_FLAGS = FUNMAP | FSECONDARY | FDUP  # freebayes default read filters


def project_read(rec: SAMRecord, start: int, end: int):
    """Project one alignment onto window [start, end).

    Returns (span_lo, proj, qual, rpos, events): compact arrays over the
    read's covered span (window offsets [span_lo, span_lo + len)), with
    base codes (-1 = deletion gap), plus indel events.
    """
    lo = max(rec.pos, start)
    hi = min(rec.end_pos(), end)
    if hi <= lo:
        return 0, None, None, None, []
    L = hi - lo
    proj = np.full(L, -1, dtype=np.int8)
    qual = np.zeros(L, dtype=np.int8)
    rpos = np.full(L, -1, dtype=np.int32)
    events = []
    seq = rec.seq
    quals = rec.qual
    has_qual = quals not in ("*", "")
    enc = encode_bases(seq.encode()) if seq not in ("*", "") else None
    qarr_full = (
        np.frombuffer(quals.encode(), np.uint8) - 33 if has_qual else None
    )
    ri = rec.pos  # ref cursor
    qi = 0        # query cursor
    for op, ln in rec.cigar:
        if op in (0, 7, 8):  # M/=/X
            a = max(ri, lo)
            b = min(ri + ln, hi)
            if a < b and enc is not None:
                off = a - ri
                proj[a - lo : b - lo] = enc[qi + off : qi + off + (b - a)]
                if has_qual:
                    qual[a - lo : b - lo] = np.minimum(
                        qarr_full[qi + off : qi + off + (b - a)], 60
                    )
                else:
                    qual[a - lo : b - lo] = 30
                rpos[a - lo : b - lo] = np.arange(qi + off, qi + off + (b - a))
            ri += ln
            qi += ln
        elif op == 1:  # I
            if start <= ri - 1 < end:
                events.append(
                    ReadEvent(ri - 1, True, ln, seq[qi : qi + ln] if enc is not None else "", -1)
                )
            qi += ln
        elif op == 2 or op == 3:  # D/N
            if op == 2 and start <= ri - 1 < end:
                events.append(ReadEvent(ri - 1, False, ln, "", -1))
            ri += ln
        elif op == 4:  # S
            qi += ln
        # H/P consume nothing
    return lo - start, proj, qual, rpos, events


def build_pileup(
    records: List[Tuple[SAMRecord, int]],
    start: int,
    end: int,
    min_mapq: int = 1,
    min_baseq: int = 3,
) -> WindowPileup:
    """Pileup over window [start, end) from (record, sample_idx) pairs."""
    L = end - start
    base_counts = np.zeros((L, 5), np.int32)
    qual_sums = np.zeros((L, 5), np.int32)
    strand_counts = np.zeros((L, 5, 2), np.int32)
    kept = []
    span_lo: List[int] = []
    projs, rquals, rposs = [], [], []
    events: List[ReadEvent] = []
    for rec, si in records:
        if rec.flag & SKIP_FLAGS or rec.mapq < min_mapq or not rec.cigar:
            continue
        if rec.flag & FSUPPLEMENTARY:
            continue
        lo, proj, qual, rpos, evs = project_read(rec, start, end)
        if proj is None:
            continue
        idx = len(kept)
        for e in evs:
            e.read_idx = idx
        cov = proj >= 0
        lowq = cov & (qual < min_baseq)
        proj[lowq] = -1
        cov = proj >= 0
        pos_idx = np.nonzero(cov)[0]
        bases = proj[pos_idx].astype(np.int64)
        np.add.at(base_counts, (pos_idx + lo, bases), 1)
        np.add.at(qual_sums, (pos_idx + lo, bases), qual[pos_idx])
        st = 1 if rec.is_reverse() else 0
        np.add.at(strand_counts, (pos_idx + lo, bases, st), 1)
        kept.append((rec, si))
        span_lo.append(lo)
        projs.append(proj)
        rquals.append(qual)
        rposs.append(rpos)
        events.extend(evs)
    R = len(kept)
    lens = np.array([len(p) for p in projs], np.int64)
    rstart = np.array(span_lo, np.int32) if R else np.zeros(0, np.int32)
    rend = (rstart + lens).astype(np.int32) if R else np.zeros(0, np.int32)
    base_idx = np.concatenate([[0], np.cumsum(lens)[:-1]]) if R else np.zeros(0, np.int64)
    # columnar per-read metadata
    slen = np.array(
        [len(r.seq) if r.seq not in ("*", "") else 0 for r, _ in kept],
        np.int32) if R else np.zeros(0, np.int32)
    Lmax = int(slen.max()) if R else 0
    read_seq = np.full((R, Lmax), 4, np.uint8)
    for i, (r, _) in enumerate(kept):
        if slen[i]:
            read_seq[i, : slen[i]] = encode_bases(r.seq.encode())
    return WindowPileup(
        start=start,
        end=end,
        base_counts=base_counts,
        qual_sums=qual_sums,
        strand_counts=strand_counts,
        depth=base_counts.sum(axis=1),
        reads=kept,
        rstart=rstart,
        rend=rend,
        base_idx=base_idx.astype(np.int64),
        flat_proj=np.concatenate(projs) if R else np.zeros(0, np.int8),
        flat_qual=np.concatenate(rquals) if R else np.zeros(0, np.int8),
        flat_rpos=np.concatenate(rposs) if R else np.zeros(0, np.int32),
        events=events,
        sample_of_read=np.array([si for _, si in kept], np.int32),
        strand=np.array([1 if r.is_reverse() else 0 for r, _ in kept],
                        np.int8),
        read_pos=np.array([r.pos for r, _ in kept], np.int32)
        if R else np.zeros(0, np.int32),
        read_len=slen,
        read_seq=read_seq,
    )


# ------------------------------------------------------- columnar builder

_CIG_QCONSUME = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0], bool)  # M I S = X
_CIG_RCONSUME = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0], bool)  # M D N = X


def build_pileup_columns(
    cols,                          # native.BamColumns (decoded records)
    sample_of_read: np.ndarray,    # (n,) int32 sample index per record
    start: int,
    end: int,
    min_mapq: int = 1,
    min_baseq: int = 3,
    tid: Optional[int] = None,
) -> WindowPileup:
    """Columnar pileup: the vectorized twin of build_pileup.

    Operates on native-decoded record columns (csrc ssq_bam_decode): the
    cigar op table and the read filters are whole-batch numpy ops, and the
    aligned bases' expansion into the span layout and the counts is one
    native pass (csrc ssq_pileup_expand); no per-read Python.  Produces a
    WindowPileup identical in content to the record path (same filters,
    same span layout), minus the SAMRecord list (reads=[])."""
    L = end - start
    n = cols.n
    flags = cols.flag.astype(np.int64)
    ncig = np.diff(cols.cigar_off)
    slen = np.diff(cols.seq_off).astype(np.int32)

    # ---- cigar op table (all records at once) --------------------------
    rid_op = np.repeat(np.arange(n, dtype=np.int64), ncig)
    ops = (cols.cigar_blob & 0xF).astype(np.int64)
    lens = (cols.cigar_blob >> 4).astype(np.int64)
    opc = np.minimum(ops, 9)
    qc = np.where(_CIG_QCONSUME[opc], lens, 0)
    rc = np.where(_CIG_RCONSUME[opc], lens, 0)
    cq = np.cumsum(qc) - qc          # exclusive
    cr = np.cumsum(rc) - rc
    first = cols.cigar_off[:-1][rid_op]
    cq0 = np.concatenate([[0], np.cumsum(qc)])[first]
    cr0 = np.concatenate([[0], np.cumsum(rc)])[first]
    q_start = cq - cq0                                   # read offset per op
    r_start = cols.pos[rid_op].astype(np.int64) + (cr - cr0)  # abs ref pos
    ref_len = np.zeros(n, np.int64)
    np.add.at(ref_len, rid_op, rc)
    end_pos = cols.pos.astype(np.int64) + ref_len

    # ---- read filters (freebayes defaults, as build_pileup) ------------
    keep = (
        ((flags & (SKIP_FLAGS | FSUPPLEMENTARY)) == 0)
        & (cols.mapq >= min_mapq) & (ncig > 0) & (slen > 0)
        & (cols.pos < end) & (end_pos > start)
    )
    if tid is not None:
        keep &= cols.tid == tid
    kidx = np.nonzero(keep)[0]
    R = len(kidx)
    base_counts = np.zeros((L, 5), np.int32)
    qual_sums = np.zeros((L, 5), np.int32)
    strand_counts = np.zeros((L, 5, 2), np.int32)
    if R == 0:
        return WindowPileup(
            start=start, end=end, base_counts=base_counts,
            qual_sums=qual_sums, strand_counts=strand_counts,
            depth=base_counts.sum(axis=1), reads=[],
            rstart=np.zeros(0, np.int32), rend=np.zeros(0, np.int32),
            base_idx=np.zeros(0, np.int64),
            flat_proj=np.zeros(0, np.int8), flat_qual=np.zeros(0, np.int8),
            flat_rpos=np.zeros(0, np.int32), events=[],
        )
    new_id = np.full(n, -1, np.int64)
    new_id[kidx] = np.arange(R)

    # encoded seq codes for the whole blob (ASCII → 0..4)
    seq_codes = encode_bases(cols.seq_blob)
    strand = ((flags[kidx] & 16) != 0).astype(np.int8)

    # ---- span-compact flat layout --------------------------------------
    rstart = np.maximum(cols.pos[kidx].astype(np.int64), start) - start
    rend = np.minimum(end_pos[kidx], end) - start
    spans = (rend - rstart).astype(np.int64)
    base_idx = np.zeros(R, np.int64)
    np.cumsum(spans[:-1], out=base_idx[1:])
    total = int(spans.sum())
    flat_proj = np.full(total, -1, np.int8)
    flat_qual = np.zeros(total, np.int8)
    flat_rpos = np.full(total, -1, np.int32)

    # ---- expand aligned (M/=/X) ops into per-base entries ---------------
    # one native pass (ssq_pileup_expand): fills the span layout and the
    # count matrices in place
    native.pileup_expand(
        np.ascontiguousarray(cols.pos[kidx].astype(np.int64)),
        np.ascontiguousarray(cols.seq_off[:-1][kidx].astype(np.int64)),
        np.ascontiguousarray(cols.seq_blob, np.uint8),
        np.ascontiguousarray(cols.qual_blob, np.uint8),
        np.ascontiguousarray(cols.cigar_blob, np.uint32),
        np.ascontiguousarray(cols.cigar_off[:-1][kidx].astype(np.int64)),
        np.ascontiguousarray(cols.cigar_off[1:][kidx].astype(np.int64)),
        np.ascontiguousarray(rstart), np.ascontiguousarray(base_idx),
        np.ascontiguousarray(strand, np.int8),
        int(start), int(end), int(min_baseq),
        flat_proj, flat_qual, flat_rpos,
        base_counts, qual_sums, strand_counts)

    # ---- indel events (I/D ops anchored at the base before) -------------
    events: List[ReadEvent] = []
    ev_keep = ((ops == 1) | (ops == 2)) & (new_id[rid_op] >= 0)
    for j in np.nonzero(ev_keep)[0]:
        pos_ev = int(r_start[j]) - 1
        if not (start <= pos_ev < end):
            continue
        ri = int(new_id[rid_op[j]])
        if ops[j] == 1:
            s0 = int(cols.seq_off[rid_op[j]] + q_start[j])
            seq = cols.seq_blob[s0 : s0 + int(lens[j])].tobytes().decode()
            events.append(ReadEvent(pos_ev, True, int(lens[j]), seq, ri))
        else:
            events.append(ReadEvent(pos_ev, False, int(lens[j]), "", ri))

    # ---- per-read metadata ----------------------------------------------
    slen_k = slen[kidx]
    Lmax = int(slen_k.max())
    read_seq = np.full((R, Lmax), 4, np.uint8)
    src = (cols.seq_off[:-1][kidx, None] + np.arange(Lmax)[None, :])
    valid = np.arange(Lmax)[None, :] < slen_k[:, None]
    read_seq[valid] = np.minimum(
        seq_codes[np.where(valid, src, 0)], 4)[valid]

    return WindowPileup(
        start=start, end=end, base_counts=base_counts,
        qual_sums=qual_sums, strand_counts=strand_counts,
        depth=base_counts.sum(axis=1), reads=[],
        rstart=rstart.astype(np.int32), rend=rend.astype(np.int32),
        base_idx=base_idx, flat_proj=flat_proj, flat_qual=flat_qual,
        flat_rpos=flat_rpos, events=events,
        sample_of_read=np.asarray(sample_of_read, np.int32)[kidx],
        strand=strand,
        read_pos=cols.pos[kidx].astype(np.int32),
        read_len=slen_k,
        read_seq=read_seq,
    )
