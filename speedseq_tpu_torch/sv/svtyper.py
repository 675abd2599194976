"""Breakend genotyping (SVTyper-equivalent).

[external knowledge: Chiang et al. 2015 — Bayesian genotyping from
ref/alt read support at breakpoints].  Reference contract: ``svtyper -q
-i sv.vcf -B full.bam -S splitters.bam`` chained per sample
(bin/speedseq:1488-1505); the fast path relies on the MC/MQ mate tags our
aligner epilogue writes (README.md:170).

All calls of a sample are genotyped by one device program per R tier
(sv/device.py ``svtyper_program``) over the whole BAM decoded once into
sorted record columns by the native codec; a decode error raises.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from math import lgamma, log, log10
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..formats.sam import (
    FDUP, FMUNMAP, FPROPER_PAIR, FREVERSE, FSECONDARY, FSUPPLEMENTARY,
    FUNMAP,
)
from .cluster import SVCall
from .evidence import BND, DEL, DUP, INV, InsertStats


@dataclass
class GenotypeResult:
    gt: str
    gq: int
    sq: float
    gl: List[float]
    dp: int
    ro: int
    ao: int
    rs: int   # ref splits (clean crossings)
    as_: int  # alt splits
    rp: int   # ref pairs
    ap: int   # alt pairs
    ab: float


def _log_choose(n: int, k: int) -> float:
    return lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)


def genotype_from_counts(ref: int, alt: int, p_err: float = 1e-3) -> GenotypeResult:
    """Diploid GL from ref/alt observation counts (svtyper's bayesian
    allele-balance model), on the host in float64: the statement the
    device program's ``genotype_counts`` vectorises."""
    n = ref + alt
    gls = []
    for p_alt in (p_err, 0.5, 1.0 - p_err):
        ll = (
            _log_choose(n, alt)
            + alt * log(max(p_alt, 1e-12))
            + ref * log(max(1.0 - p_alt, 1e-12))
        ) / log(10)
        gls.append(ll)
    order = np.argsort(gls)[::-1]
    best, second = order[0], order[1]
    gt = {0: "0/0", 1: "0/1", 2: "1/1"}[int(best)]
    gq = int(min(99, round(10.0 * (gls[best] - gls[second]))))
    # SQ: phred-scaled P(variant) = 1 - posterior(0/0), in log space
    m = max(gls)
    post = np.exp((np.array(gls) - m) * log(10))
    log10_p0 = (gls[0] - m) - log10(post.sum())
    sq = round(min(200.0, -10.0 * max(log10_p0, -20.0)), 2)
    ab = round(alt / n, 2) if n else 0.0
    return GenotypeResult(
        gt=gt, gq=gq, sq=sq,
        gl=[round(g, 0) for g in gls],
        dp=n, ro=ref, ao=alt, rs=0, as_=0, rp=0, ap=0, ab=ab,
    )


class SVGenotyper:
    """Counts ref/alt support for SV calls in one sample's BAMs."""

    def __init__(self, full_bam: str, stats: InsertStats, device=None):
        self.stats = stats
        self.device = resolve_device(device)
        self._path = full_bam
        self._cols_cache = None
        self._lock = threading.Lock()

    def close(self):
        self._cols_cache = None

    def genotype_all(self, calls: List[SVCall], min_mapq: int = 1,
                     mesh=None) -> List[GenotypeResult]:
        """All calls in one device program per R tier.

        The whole BAM decodes once into sorted record columns; one sorted
        searchsorted sweep gives each (call, breakpoint) its record range;
        the program gathers the (C, 2, R) windows, classifies
        split/crossing/pair evidence, counts, and genotypes.  Counts are
        integer-identical to svtyper's per-record rules.  ``mesh`` (a
        parallel.mesh.Mesh) shards each program's call axis, with the
        record columns replicated (sv.device.svtyper_program)."""
        from . import device as dev

        if not calls:
            return []
        (keys, rec_np, mapq, max_span) = self._columns()
        rec = [torch.as_tensor(a, device=self.device) for a in rec_np]
        rec[6] = rec[6] & torch.as_tensor(mapq >= min_mapq, device=self.device)

        stats = self.stats
        w = stats.max_normal
        C = len(calls)
        tid1 = np.fromiter((c.tid1 for c in calls), np.int32, C)
        pos1 = np.fromiter((c.pos1 for c in calls), np.int32, C)
        tid2 = np.fromiter((c.tid2 for c in calls), np.int32, C)
        pos2 = np.fromiter((c.pos2 for c in calls), np.int32, C)
        st1 = np.fromiter((c.strand1 for c in calls), np.int32, C)
        st2 = np.fromiter((c.strand2 for c in calls), np.int32, C)
        code = np.fromiter(
            ({DEL: dev.SV_DEL, DUP: dev.SV_DUP, INV: dev.SV_INV,
              BND: dev.SV_BND}[c.svtype] for c in calls), np.int32, C)

        # one sorted sweep: window [pos-w-max_span, pos+w) per (call, side)
        tt = np.stack([tid1, tid2], 1).astype(np.int64)     # (C, 2)
        pp = np.stack([pos1, pos2], 1).astype(np.int64)
        lo_key = (tt << 34) + np.maximum(pp - w - max_span, 0) + 1
        hi_key = (tt << 34) + np.maximum(pp + w, 0) + 1
        a = np.searchsorted(keys, lo_key.ravel()).reshape(C, 2)
        b = np.searchsorted(keys, hi_key.ravel()).reshape(C, 2)

        # R tiers: when the widest window is >= 4x the 75th percentile and
        # few calls need it, outlier-depth calls run as a second small
        # batch at R_big, so one deep pileup does not widen every call's
        # (2, R) window
        span_pc = (b - a).max(axis=1)
        R_big = dev._pow2(int(span_pc.max()))
        R_small = dev._pow2(int(np.percentile(span_pc, 75)))
        if R_big >= 4 * R_small and int((span_pc > R_small).sum()) <= C // 4:
            hot = span_pc > R_small
            tiers = [np.nonzero(~hot)[0], np.nonzero(hot)[0]]
            tier_R = [R_small, R_big]
        else:
            tiers = [np.arange(C)]
            tier_R = [R_big]

        wiggle = 4 * int(stats.std)
        scalars = (6, w, wiggle, stats.max_normal)
        outs = [dev.svtyper_program(
            a[sub], b[sub], R, rec,
            tuple(c[sub] for c in (code, tid1, pos1, tid2, pos2, st1, st2)),
            scalars, device=self.device, mesh=mesh)
            for sub, R in zip(tiers, tier_R)]
        # stitch tiers back into call order
        merged = []
        for k in range(11):
            parts = [o[k].cpu().numpy() for o in outs]
            full = np.zeros((C,) + parts[0].shape[1:], parts[0].dtype)
            for sub, part in zip(tiers, parts):
                full[sub] = part
            merged.append(full)
        ref_n, alt_n, rs, as_, rp, ap, gl, gt, gq, sq, ab = merged
        gt_s = {0: "0/0", 1: "0/1", 2: "1/1"}
        res = []
        for i in range(C):
            n = int(ref_n[i] + alt_n[i])
            res.append(GenotypeResult(
                gt=gt_s[int(gt[i])], gq=int(gq[i]),
                sq=round(float(sq[i]), 2),
                gl=[round(float(x), 0) for x in gl[i]],
                dp=n, ro=int(ref_n[i]), ao=int(alt_n[i]),
                rs=int(rs[i]), as_=int(as_[i]),
                rp=int(rp[i]), ap=int(ap[i]),
                ab=round(int(alt_n[i]) / n, 2) if n else 0.0,
            ))
        return res

    def _columns(self):
        """Decode the whole BAM once into sorted record columns (cached):
        (search keys, 14 record columns, mapq, max reference span)."""
        with self._lock:
            if self._cols_cache is None:
                self._cols_cache = self._decode()
            return self._cols_cache

    def _decode(self):
        from .columnar import (
            clip_flags, end_positions, mate_ref_lengths, read_bam_columns,
            ztag_strings,
        )

        _refs, cols = read_bam_columns(self._path)
        flags = cols.flag.astype(np.int64)
        pos = cols.pos.astype(np.int64)
        tid = cols.tid.astype(np.int64)
        endp = end_positions(cols).astype(np.int64)
        mtid = cols.mtid.astype(np.int64)
        mpos = cols.mpos.astype(np.int64)
        mrl = mate_ref_lengths(cols, self.stats.read_len)
        cl, cr = clip_flags(cols)
        sa_off, _ = ztag_strings(cols, "SA")
        sa = sa_off >= 0
        mapq = cols.mapq
        # searchsorted keys: ADD (pos+1), never OR — unmapped tail records
        # have pos = -1 and a bitwise OR with -1 gives -1, breaking the
        # sorted invariant and emptying every gather window
        skeys = (np.where(tid < 0, np.int64(2**20 - 1), tid) << 34) + (pos + 1)
        if np.any(np.diff(skeys) < 0):   # not coordinate-sorted: sort now
            order = np.argsort(skeys, kind="stable")
            (flags, pos, tid, endp, skeys, mtid, mpos, mrl, cl, cr, sa,
             mapq) = (x[order] for x in (flags, pos, tid, endp, skeys, mtid,
                                         mpos, mrl, cl, cr, sa, mapq))
        base = (flags & (FUNMAP | FSECONDARY | FDUP | FSUPPLEMENTARY)) == 0
        rev1 = (flags & FREVERSE) != 0
        rev2 = (flags & 0x20) != 0
        proper = (flags & FPROPER_PAIR) != 0
        mateok = ((flags & FMUNMAP) == 0) & (mtid >= 0)
        mend = mpos + mrl
        max_span = int(np.maximum(endp - pos, 0).max()) if len(pos) else 0
        i32 = lambda x: x.astype(np.int32)
        rec = (i32(pos), i32(endp), i32(tid), i32(mtid), i32(mpos),
               i32(mend), base, cl.astype(bool), cr.astype(bool),
               sa.astype(bool), rev1, rev2, proper, mateok)
        return skeys, rec, mapq.astype(np.int32), max_span
