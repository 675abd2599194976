"""SV evidence extraction: discordant pairs + split reads → breakpoint
predictions with probability intervals.

LUMPY's model [external knowledge: Layer et al. 2014]: every evidence item
maps to a pair of breakpoint probability intervals; the reference pins the
knobs — min sample weight 4 (``-m``, bin/speedseq:1242), trim 0 (``-r``,
:1243), exclude BED (``-x``, :1287), insert stats from sampled pairs
(pairend_distro.py, Makefile:121).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..formats.bam import BAMReader
from ..formats.bed import ExcludeMask
from ..formats.sam import (
    FDUP, FMUNMAP, FPROPER_PAIR, FREAD1, FREVERSE, FMREVERSE, FSECONDARY,
    FSUPPLEMENTARY, FUNMAP, SAMRecord, cigar_from_str, cigar_ref_len,
    cigar_query_len,
)

# SV types
DEL, DUP, INV, BND = "DEL", "DUP", "INV", "BND"


@dataclass
class InsertStats:
    """pairend_distro.py-equivalent insert histogram + moments."""

    mean: float
    std: float
    read_len: int
    hist: np.ndarray       # P(isize = i), i in [0, max)
    sf: np.ndarray         # P(isize >= i) survival function

    @classmethod
    def from_bam(cls, bam_path: str, n_sample: int = 10_000,
                 outlier_mult: float = 10.0) -> "InsertStats":
        """Sample proper pairs from the full BAM (lumpyexpress samples the
        first N pairs through pairend_distro.py).

        Columnar: a bounded raw-record prefix decodes in one native call
        and the flag/tlen selection is vectorized; the per-record
        SAMRecord fallback only runs without the native codec."""
        from .. import native

        isizes: List[int] = []
        rlen = 100
        if native.available():
            import struct as _struct

            # bulk-chunk ingestion: 4 MiB decompressed spans per read
            # (block-sized copies inside BGZFReader.read), one native
            # columnar decode per chunk, until n_sample qualifying
            # tlen>0 records are collected or EOF — the same
            # termination condition as the per-record fallback below.
            excl = FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY | FDUP
            tl_parts: List[np.ndarray] = []
            count = 0
            with BAMReader(bam_path) as rd:
                buf = b""
                while count < n_sample:
                    more = rd._r.read(1 << 22)
                    buf += more
                    # longest whole-record prefix (records can straddle
                    # chunk boundaries; the tail carries over)
                    off, nb = 0, len(buf)
                    while off + 4 <= nb:
                        (bs,) = _struct.unpack_from("<i", buf, off)
                        if off + 4 + bs > nb:
                            break
                        off += 4 + bs
                    if off:
                        cols = native.bam_decode(buf[:off])
                        buf = buf[off:]
                        flags = cols.flag.astype(np.int64)
                        keep = ((flags & excl) == 0) & (cols.tlen > 0)
                        tl_parts.append(cols.tlen[keep])
                        count += int(keep.sum())
                        slen = np.diff(cols.seq_off)[keep]
                        if len(slen):
                            rlen = max(rlen, int(slen.max()))
                    if not more:
                        break
            if tl_parts:
                isizes = np.concatenate(tl_parts)[:n_sample].tolist()
        else:
            with BAMReader(bam_path) as rd:
                for rec in rd:
                    if rec.flag & (FUNMAP | FMUNMAP | FSECONDARY
                                   | FSUPPLEMENTARY | FDUP):
                        continue
                    if rec.tlen > 0:
                        isizes.append(rec.tlen)
                        if rec.seq != "*":
                            rlen = max(rlen, len(rec.seq))
                    if len(isizes) >= n_sample:
                        break
        if not isizes:
            return cls.synthetic(320.0, 50.0, rlen)
        v = np.asarray(isizes, dtype=np.float64)
        m = v.mean()
        v = v[v <= outlier_mult * m]  # pairend_distro -X outlier cut
        mean, std = float(v.mean()), float(max(v.std(), 1.0))
        hi = int(mean + 5 * std) + 1
        hist = np.bincount(np.clip(v.astype(np.int64), 0, hi - 1), minlength=hi)
        hist = hist / hist.sum()
        sf = hist[::-1].cumsum()[::-1]
        return cls(mean=mean, std=std, read_len=rlen, hist=hist, sf=sf)

    @classmethod
    def synthetic(cls, mean: float, std: float, read_len: int = 100) -> "InsertStats":
        hi = int(mean + 5 * std) + 1
        x = np.arange(hi)
        hist = np.exp(-0.5 * ((x - mean) / std) ** 2)
        hist /= hist.sum()
        sf = hist[::-1].cumsum()[::-1]
        return cls(mean, std, read_len, hist, sf)

    @property
    def max_normal(self) -> int:
        return int(self.mean + 4 * self.std)  # discordance threshold


@dataclass
class Breakpoint:
    """One predicted breakpoint pair with probability intervals."""

    svtype: str
    tid1: int
    strand1: int           # orientation at breakpoint 1 (0 = +, 1 = -)
    start1: int            # interval start of breakpoint 1
    prob1: np.ndarray      # probability over [start1, start1+len)
    tid2: int
    strand2: int
    start2: int
    prob2: np.ndarray
    weight: int            # evidence weight (1 per read/pair)
    sample: int
    is_split: bool
    qname: str = ""


def classify_pair(
    tid1: int, pos1: int, end1: int, rev1: bool,
    tid2: int, pos2: int, end2: int, rev2: bool,
    stats: InsertStats,
) -> Optional[str]:
    """SV type implied by a discordant pair's orientation [ext: lumpy]."""
    if tid1 != tid2:
        return BND
    if rev1 == rev2:
        return INV
    # order by position
    if pos1 <= pos2:
        first_rev, second_rev = rev1, rev2
        span = max(end1, end2) - min(pos1, pos2)
    else:
        first_rev, second_rev = rev2, rev1
        span = max(end1, end2) - min(pos1, pos2)
    if not first_rev and second_rev:
        # FR: deletion if span too large (too small = insertion; not called)
        return DEL if span > stats.max_normal else None
    if first_rev and not second_rev:
        return DUP
    return None


def pair_breakpoint(
    rec: SAMRecord, stats: InsertStats, sample: int
) -> Optional[Breakpoint]:
    """Breakpoint prediction from one discordant read (uses mate info; we
    emit one Breakpoint per pair, from the leftmost read only)."""
    if rec.flag & (FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY | FDUP):
        return None
    if rec.mtid < 0:
        return None
    # only process from the leftmost end to avoid double-counting
    if (rec.tid, rec.pos) > (rec.mtid, rec.mpos):
        return None
    if (rec.tid, rec.pos) == (rec.mtid, rec.mpos) and not (rec.flag & 0x40):
        return None
    rev1 = bool(rec.flag & FREVERSE)
    rev2 = bool(rec.flag & FMREVERSE)
    end1 = rec.end_pos()
    qlen = cigar_query_len(rec.cigar) or stats.read_len
    mc = rec.get_tag("MC")
    mate_rlen = cigar_ref_len(cigar_from_str(mc)) if mc else stats.read_len
    end2 = rec.mpos + mate_rlen
    svtype = classify_pair(
        rec.tid, rec.pos, end1, rev1, rec.mtid, rec.mpos, end2, rev2, stats
    )
    if svtype is None:
        return None
    D = max(8, stats.max_normal - 2 * stats.read_len)
    # probability of the break being o bases beyond the read end decays
    # with the insert survival function (lumpy's pe distribution)
    span0 = int(end2 - rec.pos)
    probs = stats.sf[
        np.clip(span0 + np.arange(D), 0, len(stats.sf) - 1)
    ].astype(np.float64)
    if probs.sum() <= 0:
        probs = np.ones(D)
    probs = probs / probs.sum()
    if svtype == DEL:
        # + read: break1 in [end1, end1+D); - mate: break2 in (mpos-D, mpos]
        return Breakpoint(
            svtype=svtype, tid1=rec.tid, strand1=0, start1=end1,
            prob1=probs.copy(), tid2=rec.mtid, strand2=1,
            start2=rec.mpos - D + 1, prob2=probs[::-1].copy(),
            weight=1, sample=sample, is_split=False, qname=rec.qname,
        )
    if svtype == DUP:
        # - read first: break1 in (pos-D, pos]; + mate: break2 in [end2, end2+D)
        return Breakpoint(
            svtype=svtype, tid1=rec.tid, strand1=1,
            start1=rec.pos - D + 1, prob1=probs[::-1].copy(),
            tid2=rec.mtid, strand2=0, start2=end2, prob2=probs.copy(),
            weight=1, sample=sample, is_split=False, qname=rec.qname,
        )
    if svtype == INV:
        if not rev1:  # ++ : breaks right of both ends
            return Breakpoint(
                svtype=svtype, tid1=rec.tid, strand1=0, start1=end1,
                prob1=probs.copy(), tid2=rec.mtid, strand2=0, start2=end2,
                prob2=probs.copy(), weight=1, sample=sample, is_split=False,
                qname=rec.qname,
            )
        return Breakpoint(  # -- : breaks left of both starts
            svtype=svtype, tid1=rec.tid, strand1=1, start1=rec.pos - D + 1,
            prob1=probs[::-1].copy(), tid2=rec.mtid, strand2=1,
            start2=rec.mpos - D + 1, prob2=probs[::-1].copy(),
            weight=1, sample=sample, is_split=False, qname=rec.qname,
        )
    # BND (inter-chromosomal)
    s1 = 0 if not rev1 else 1
    s2 = 0 if not rev2 else 1
    return Breakpoint(
        svtype=BND, tid1=rec.tid, strand1=s1,
        start1=end1 if s1 == 0 else rec.pos - D + 1,
        prob1=probs.copy() if s1 == 0 else probs[::-1].copy(),
        tid2=rec.mtid, strand2=s2,
        start2=end2 if s2 == 0 else rec.mpos - D + 1,
        prob2=probs.copy() if s2 == 0 else probs[::-1].copy(),
        weight=1, sample=sample, is_split=False, qname=rec.qname,
    )


_SLOP = 3  # split-read breakpoint uncertainty (lumpy sr back-off)


def split_breakpoint(
    rec: SAMRecord, sample: int, name_to_tid, stats: InsertStats
) -> Optional[Breakpoint]:
    """Breakpoint from a split read (primary record carrying an SA tag)."""
    if rec.flag & (FUNMAP | FSECONDARY | FDUP | FSUPPLEMENTARY):
        return None
    sa = rec.get_tag("SA")
    if not sa:
        return None
    seg = sa.split(";")[0].split(",")
    if len(seg) < 6:
        return None
    stid = name_to_tid(seg[0])
    spos = int(seg[1]) - 1
    sstrand = 0 if seg[2] == "+" else 1
    scigar = cigar_from_str(seg[3])
    send = spos + cigar_ref_len(scigar)
    rev1 = 1 if rec.flag & FREVERSE else 0
    pend = rec.end_pos()
    # junction side per piece: the side where the clip is
    lead1 = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] in (4, 5) else 0
    tail1 = rec.cigar[-1][1] if rec.cigar and rec.cigar[-1][0] in (4, 5) else 0
    bp1 = pend if tail1 >= lead1 else rec.pos
    o1 = 0 if tail1 >= lead1 else 1
    lead2 = scigar[0][1] if scigar and scigar[0][0] in (4, 5) else 0
    tail2 = scigar[-1][1] if scigar and scigar[-1][0] in (4, 5) else 0
    bp2 = send if tail2 >= lead2 else spos
    o2 = 0 if tail2 >= lead2 else 1
    if stid != rec.tid:
        svtype = BND
    elif rev1 != sstrand:
        svtype = INV
    else:
        # same strand: order breaks; junction-side orientation decides
        lo, hi = min(bp1, bp2), max(bp1, bp2)
        lo_o = o1 if bp1 <= bp2 else o2
        if lo_o == 0:
            svtype = DEL
        else:
            svtype = DUP
    prob = np.zeros(2 * _SLOP + 1)
    prob[_SLOP] = 0.8
    prob[:_SLOP] = 0.1 / _SLOP
    prob[_SLOP + 1 :] = 0.1 / _SLOP
    # order breakpoints (tid, pos)
    if (stid, bp2) < (rec.tid, bp1):
        (t1, b1, s1), (t2, b2, s2) = (stid, bp2, o2), (rec.tid, bp1, o1)
    else:
        (t1, b1, s1), (t2, b2, s2) = (rec.tid, bp1, o1), (stid, bp2, o2)
    return Breakpoint(
        svtype=svtype, tid1=t1, strand1=s1, start1=b1 - _SLOP,
        prob1=prob.copy(), tid2=t2, strand2=s2, start2=b2 - _SLOP,
        prob2=prob.copy(), weight=1, sample=sample, is_split=True,
        qname=rec.qname,
    )


def collect_evidence(
    disc_paths: List[str],
    split_paths: List[str],
    stats: List[InsertStats],
    exclude: Optional[ExcludeMask] = None,
    ref_names: Optional[List[str]] = None,
) -> List[Breakpoint]:
    """Gather all evidence from per-sample discordant + splitter BAMs.

    Columnar when the native codec is available (whole-file decode, flag/
    orientation classification and probability-curve construction as
    numpy column ops; Breakpoint objects exist only for actual evidence);
    per-record fallback otherwise."""
    from .. import native

    if native.available():
        return _collect_evidence_columnar(
            disc_paths, split_paths, stats, exclude)
    out: List[Breakpoint] = []
    for si, path in enumerate(disc_paths):
        with BAMReader(path) as rd:
            names = [n for n, _ in rd.header.refs]
            for rec in rd:
                bp = pair_breakpoint(rec, stats[si], si)
                if bp is None:
                    continue
                if exclude is not None and (
                    exclude.contains(names[bp.tid1], [bp.start1])[0]
                    or exclude.contains(names[bp.tid2], [bp.start2])[0]
                ):
                    continue
                out.append(bp)
    for si, path in enumerate(split_paths):
        with BAMReader(path) as rd:
            names = [n for n, _ in rd.header.refs]
            n2t = {n: i for i, n in enumerate(names)}
            for rec in rd:
                bp = split_breakpoint(
                    rec, si, lambda n: n2t.get(n, -1), stats[si]
                )
                if bp is None or bp.tid1 < 0 or bp.tid2 < 0:
                    continue
                if exclude is not None and (
                    exclude.contains(names[bp.tid1], [bp.start1])[0]
                    or exclude.contains(names[bp.tid2], [bp.start2])[0]
                ):
                    continue
                out.append(bp)
    return out


def _pair_probs(stats: InsertStats, span0: np.ndarray, D: int) -> np.ndarray:
    """(n, D) normalized breakpoint-offset probability rows: the insert
    survival function evaluated span0+o for offset o (lumpy's pe curve)."""
    idx = np.clip(span0[:, None] + np.arange(D)[None, :], 0,
                  len(stats.sf) - 1)
    probs = stats.sf[idx].astype(np.float64)
    sums = probs.sum(axis=1, keepdims=True)
    flat = sums[:, 0] <= 0
    if flat.any():
        probs[flat] = 1.0
        sums = probs.sum(axis=1, keepdims=True)
    return probs / sums


def _excluded(exclude, names, tid, pos) -> np.ndarray:
    out = np.zeros(len(tid), bool)
    for t in np.unique(tid):
        m = tid == t
        out[m] = exclude.contains(names[int(t)], pos[m])
    return out


def _pair_evidence_columnar(
    path: str, stats: InsertStats, si: int, exclude: Optional[ExcludeMask],
) -> List[Breakpoint]:
    """Vectorized twin of pair_breakpoint over a whole discordants BAM."""
    from .columnar import end_positions, mate_ref_lengths, read_bam_columns

    refs, cols = read_bam_columns(path)
    names = [n for n, _ in refs]
    flags = cols.flag.astype(np.int64)
    tid = cols.tid.astype(np.int64)
    pos = cols.pos.astype(np.int64)
    mtid = cols.mtid.astype(np.int64)
    mpos = cols.mpos.astype(np.int64)
    keep = (
        ((flags & (FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY | FDUP))
         == 0)
        & (mtid >= 0)
    )
    # leftmost-end-only (avoid double counting); ties resolved to read 1
    lt = (tid < mtid) | ((tid == mtid) & (pos < mpos))
    eq = (tid == mtid) & (pos == mpos)
    keep &= lt | (eq & ((flags & FREAD1) != 0))
    ki = np.nonzero(keep)[0]
    if len(ki) == 0:
        return []
    end1 = end_positions(cols)[ki]
    mate_rl = mate_ref_lengths(cols, stats.read_len)[ki]
    tid, pos, mtid, mpos, flags = (
        tid[ki], pos[ki], mtid[ki], mpos[ki], flags[ki])
    end2 = mpos + mate_rl
    rev1 = (flags & FREVERSE) != 0
    rev2 = (flags & FMREVERSE) != 0

    span = np.maximum(end1, end2) - np.minimum(pos, mpos)
    is_bnd = tid != mtid
    is_inv = ~is_bnd & (rev1 == rev2)
    # leftmost read first: within a tid, pos <= mpos by construction
    is_del = ~is_bnd & ~is_inv & ~rev1 & rev2 & (span > stats.max_normal)
    is_dup = ~is_bnd & ~is_inv & rev1 & ~rev2
    any_sv = is_bnd | is_inv | is_del | is_dup
    vi = np.nonzero(any_sv)[0]
    if len(vi) == 0:
        return []

    D = max(8, stats.max_normal - 2 * stats.read_len)
    span0 = (end2 - pos)[vi]
    probs = _pair_probs(stats, span0, D)

    # breakpoint intervals per type (same math as pair_breakpoint)
    tid, pos, mtid, mpos = tid[vi], pos[vi], mtid[vi], mpos[vi]
    end1, end2 = end1[vi], end2[vi]
    rev1, rev2 = rev1[vi], rev2[vi]
    is_bnd, is_inv, is_del, is_dup = (
        is_bnd[vi], is_inv[vi], is_del[vi], is_dup[vi])
    s1 = np.where(is_del, 0,
                  np.where(is_dup, 1,
                           np.where(is_inv, np.where(rev1, 1, 0),
                                    np.where(rev1, 1, 0))))
    s2 = np.where(is_del, 1,
                  np.where(is_dup, 0,
                           np.where(is_inv, np.where(rev1, 1, 0),
                                    np.where(rev2, 1, 0))))
    start1 = np.where(s1 == 0, end1, pos - D + 1)
    start2 = np.where(s2 == 0, end2, mpos - D + 1)
    if exclude is not None:
        ex = (_excluded(exclude, names, tid, start1)
              | _excluded(exclude, names, mtid, start2))
        keep2 = ~ex
        (tid, pos, mtid, mpos, end1, end2, rev1, rev2, is_bnd, is_inv,
         is_del, is_dup, s1, s2, start1, start2, probs) = (
            a[keep2] for a in (
                tid, pos, mtid, mpos, end1, end2, rev1, rev2, is_bnd,
                is_inv, is_del, is_dup, s1, s2, start1, start2, probs))
    probs_rev = probs[:, ::-1]
    svtypes = np.where(is_bnd, 0, np.where(is_inv, 1,
                                           np.where(is_del, 2, 3)))
    type_names = [BND, INV, DEL, DUP]
    out = []
    for j in range(len(tid)):
        out.append(Breakpoint(
            svtype=type_names[int(svtypes[j])],
            tid1=int(tid[j]), strand1=int(s1[j]), start1=int(start1[j]),
            prob1=(probs[j] if s1[j] == 0 else probs_rev[j]).copy(),
            tid2=int(mtid[j]), strand2=int(s2[j]), start2=int(start2[j]),
            prob2=(probs[j] if s2[j] == 0 else probs_rev[j]).copy(),
            weight=1, sample=si, is_split=False,
        ))
    return out


def _split_evidence_columnar(
    path: str, stats: InsertStats, si: int, exclude: Optional[ExcludeMask],
) -> List[Breakpoint]:
    """Split-read breakpoints over a whole splitters BAM: flag masks,
    clip sides, and primary-piece geometry are columnar; only the SA tag
    text of actual split rows is parsed per row."""
    from .columnar import clip_flags, end_positions, read_bam_columns, ztag_strings

    refs, cols = read_bam_columns(path)
    names = [n for n, _ in refs]
    n2t = {n: i for i, n in enumerate(names)}
    flags = cols.flag.astype(np.int64)
    sa_off, sa_len = ztag_strings(cols, "SA")
    keep = (
        ((flags & (FUNMAP | FSECONDARY | FDUP | FSUPPLEMENTARY)) == 0)
        & (sa_off >= 0)
    )
    ki = np.nonzero(keep)[0]
    if len(ki) == 0:
        return []
    cl, cr = clip_flags(cols)
    endp = end_positions(cols)
    lead = np.zeros(cols.n, np.int64)
    tail = np.zeros(cols.n, np.int64)
    if len(cols.cigar_blob):
        ncig = np.diff(cols.cigar_off)
        has = ncig > 0
        f_idx = np.where(has, cols.cigar_off[:-1], 0)
        l_idx = np.where(has, cols.cigar_off[1:] - 1, 0)
        lead = np.where(cl, cols.cigar_blob[f_idx] >> 4, 0).astype(np.int64)
        tail = np.where(cr, cols.cigar_blob[l_idx] >> 4, 0).astype(np.int64)
    aux = cols.aux_blob
    prob = np.zeros(2 * _SLOP + 1)
    prob[_SLOP] = 0.8
    prob[:_SLOP] = 0.1 / _SLOP
    prob[_SLOP + 1 :] = 0.1 / _SLOP
    out = []
    for i in ki:
        seg = aux[sa_off[i] : sa_off[i] + sa_len[i]].tobytes().decode()
        seg = seg.split(";")[0].split(",")
        if len(seg) < 6:
            continue
        stid = n2t.get(seg[0], -1)
        if stid < 0:
            continue
        spos = int(seg[1]) - 1
        sstrand = 0 if seg[2] == "+" else 1
        scigar = cigar_from_str(seg[3])
        send = spos + cigar_ref_len(scigar)
        rev1 = 1 if flags[i] & FREVERSE else 0
        bp1 = int(endp[i]) if tail[i] >= lead[i] else int(cols.pos[i])
        o1 = 0 if tail[i] >= lead[i] else 1
        lead2 = scigar[0][1] if scigar and scigar[0][0] in (4, 5) else 0
        tail2 = scigar[-1][1] if scigar and scigar[-1][0] in (4, 5) else 0
        bp2 = send if tail2 >= lead2 else spos
        o2 = 0 if tail2 >= lead2 else 1
        tid_i = int(cols.tid[i])
        if stid != tid_i:
            svtype = BND
        elif rev1 != sstrand:
            svtype = INV
        else:
            lo_o = o1 if bp1 <= bp2 else o2
            svtype = DEL if lo_o == 0 else DUP
        if (stid, bp2) < (tid_i, bp1):
            (t1, b1, ss1), (t2, b2, ss2) = (stid, bp2, o2), (tid_i, bp1, o1)
        else:
            (t1, b1, ss1), (t2, b2, ss2) = (tid_i, bp1, o1), (stid, bp2, o2)
        if exclude is not None and (
            exclude.contains(names[t1], [b1 - _SLOP])[0]
            or exclude.contains(names[t2], [b2 - _SLOP])[0]
        ):
            continue
        out.append(Breakpoint(
            svtype=svtype, tid1=t1, strand1=ss1, start1=b1 - _SLOP,
            prob1=prob.copy(), tid2=t2, strand2=ss2, start2=b2 - _SLOP,
            prob2=prob.copy(), weight=1, sample=si, is_split=True,
        ))
    return out


def _collect_evidence_columnar(
    disc_paths: List[str],
    split_paths: List[str],
    stats: List[InsertStats],
    exclude: Optional[ExcludeMask],
) -> List[Breakpoint]:
    out: List[Breakpoint] = []
    for si, path in enumerate(disc_paths):
        out.extend(_pair_evidence_columnar(path, stats[si], si, exclude))
    for si, path in enumerate(split_paths):
        out.extend(_split_evidence_columnar(path, stats[si], si, exclude))
    return out
