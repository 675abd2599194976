"""SV evidence extraction: discordant pairs + split reads → breakpoint
predictions with probability intervals.

LUMPY's model [external knowledge: Layer et al. 2014]: every evidence item
maps to a pair of breakpoint probability intervals; the reference pins the
knobs — min sample weight 4 (``-m``, bin/speedseq:1242), trim 0 (``-r``,
:1243), exclude BED (``-x``, :1287), insert stats from sampled pairs
(pairend_distro.py, Makefile:121).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..formats.bam import BAMReader
from ..formats.bed import ExcludeMask
from ..formats.sam import (
    FDUP, FMUNMAP, FPROPER_PAIR, FREAD1, FREVERSE, FMREVERSE, FSECONDARY,
    FSUPPLEMENTARY, FUNMAP, cigar_from_str, cigar_ref_len,
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

        A bounded raw-record prefix decodes in one native call and the
        flag/tlen selection is vectorized."""
        isizes: List[int] = []
        rlen = 100
        # bulk-chunk ingestion: 4 MiB decompressed spans per read
        # (block-sized copies inside BGZFReader.read), one native columnar
        # decode per chunk, until n_sample qualifying tlen>0 records are
        # collected or EOF
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
                    (bs,) = struct.unpack_from("<i", buf, off)
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


def collect_evidence(
    disc_paths: List[str],
    split_paths: List[str],
    stats: List[InsertStats],
    exclude: Optional[ExcludeMask] = None,
    ref_names: Optional[List[str]] = None,
) -> List[Breakpoint]:
    """Gather all evidence from per-sample discordant + splitter BAMs:
    whole-file decode, flag/orientation classification and
    probability-curve construction as numpy column ops; Breakpoint objects
    exist only for actual evidence."""
    out: List[Breakpoint] = []
    for si, path in enumerate(disc_paths):
        out.extend(_pair_evidence_columnar(path, stats[si], si, exclude))
    for si, path in enumerate(split_paths):
        out.extend(_split_evidence_columnar(path, stats[si], si, exclude))
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
    """Discordant-pair breakpoints over a whole discordants BAM, one a pair
    from its leftmost read: the SV type by the pair's orientation [ext:
    lumpy] (another contig BND, one strand INV, FR beyond ``max_normal``
    DEL, RF DUP), each side's interval weighted by the insert survival
    function."""
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

    # breakpoint intervals per type: a + side breaks in [end, end + D),
    # a - side in (start - D, start]
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


_SLOP = 3  # split-read breakpoint uncertainty (lumpy sr back-off)


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
