"""Breakpoint clustering → SV calls (LUMPY's probabilistic integration).

[external knowledge: Layer et al. 2014 — evidence distributions intersect
multiplicatively within a cluster].  The reference pins: min total weight
4 (``-m``), trim 0 (``-r``), probability curves emitted under ``-P``
(bin/speedseq:1242-1243, 1312-1313).

The sweep and the curve combination run on the run's device
(sv/device.py: the ``sv_cluster`` kernel for cluster ids, then the
per-cluster log-product curves); ``_combine`` is the host statement of
one cluster's combination.  ``_cluster_breakpoints_host`` (with
``cluster_order``) is the JAX package's host path, which no run of the
port takes: a test holds the device sweep against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .evidence import BND, Breakpoint


@dataclass
class SVCall:
    svtype: str
    tid1: int
    pos1: int
    strand1: int
    cipos: Tuple[int, int]
    cipos95: Tuple[int, int]
    prpos: np.ndarray           # normalized probability over cipos span
    tid2: int
    pos2: int
    strand2: int
    ciend: Tuple[int, int]
    ciend95: Tuple[int, int]
    prend: np.ndarray
    su: int
    pe: int
    sr: int
    sample_support: Dict[int, int]
    imprecise: bool


def _combine(
    items: List[Tuple[int, np.ndarray]],
    trim: float = 0.0,
) -> Tuple[int, Tuple[int, int], Tuple[int, int], np.ndarray]:
    """Multiply probability curves (log-sum) over their union support.

    ``trim`` is lumpy -r (bin/speedseq:1243, pinned default 0): interval
    edges whose probability falls below ``trim`` are dropped before the
    intervals/curves are emitted."""
    lo = min(s for s, p in items)
    hi = max(s + len(p) for s, p in items)
    acc = np.zeros(hi - lo)
    eps = 1e-12
    for s, p in items:
        cur = np.full(hi - lo, eps)
        cur[s - lo : s - lo + len(p)] = np.maximum(p, eps)
        acc += np.log(cur)
    acc -= acc.max()
    prob = np.exp(acc)
    prob /= prob.sum()
    if trim > 0.0:
        live = np.nonzero(prob >= trim)[0]
        if len(live):
            trimmed = np.zeros_like(prob)
            trimmed[live[0] : live[-1] + 1] = prob[live[0] : live[-1] + 1]
            prob = trimmed / trimmed.sum()
    pos = lo + int(np.argmax(prob))
    # 100% and 95% credible intervals relative to pos
    nz = np.nonzero(prob > 1e-9)[0]
    ci = (int(lo + nz[0] - pos), int(lo + nz[-1] - pos))
    order = np.argsort(prob)[::-1]
    csum = np.cumsum(prob[order])
    keep = order[: int(np.searchsorted(csum, 0.95)) + 1]
    ci95 = (int(lo + keep.min() - pos), int(lo + keep.max() - pos))
    # trim the emitted curve to the CI window
    prpos = prob[nz[0] : nz[-1] + 1]
    return pos, ci, ci95, prpos / prpos.sum()


def evidence_columns(evidence: List[Breakpoint]):
    """Evidence sorted by (group, start1, start2) as the device pass takes
    it: (sorted evidence, gid, start1, len1, curves1, start2, len2,
    curves2); a group is one (svtype, tid1, tid2, strand1, strand2)."""
    n = len(evidence)
    keys = [(b.svtype, b.tid1, b.tid2, b.strand1, b.strand2)
            for b in evidence]
    kidx = {k: i for i, k in enumerate(sorted(set(keys)))}
    gid = np.fromiter((kidx[k] for k in keys), np.int32, n)
    start1 = np.fromiter((b.start1 for b in evidence), np.int64, n)
    start2 = np.fromiter((b.start2 for b in evidence), np.int64, n)
    len1 = np.fromiter((len(b.prob1) for b in evidence), np.int64, n)
    len2 = np.fromiter((len(b.prob2) for b in evidence), np.int64, n)
    order = np.lexsort((start2, start1, gid))
    ev = [evidence[i] for i in order]
    gid, start1, start2, len1, len2 = (
        a[order] for a in (gid, start1, start2, len1, len2))
    Dmax = int(max(len1.max(), len2.max()))
    curves1 = np.zeros((n, Dmax), np.float32)
    curves2 = np.zeros((n, Dmax), np.float32)
    for i, b in enumerate(ev):
        curves1[i, : len(b.prob1)] = b.prob1
        curves2[i, : len(b.prob2)] = b.prob2
    return ev, gid, start1, len1, curves1, start2, len2, curves2


def cluster_breakpoints(
    evidence: List[Breakpoint],
    min_weight: int = 4,      # lumpy -m (bin/speedseq:1242)
    trim: float = 0.0,        # lumpy -r (bin/speedseq:1243)
    device=None,
) -> List[SVCall]:
    """Evidence → SV calls: the cluster sweep and the curve combination on
    the run's device, then the weight filters and call assembly on the
    host."""
    from . import device as _dev

    if not evidence:
        return []
    n = len(evidence)
    ev, gid, start1, len1, curves1, start2, len2, curves2 = (
        evidence_columns(evidence))
    cc = _dev.cluster_and_combine(
        gid, start1, len1, curves1, start2, len2, curves2, trim,
        device=device)
    cids, C = cc.cids, cc.n_clusters

    weight = np.fromiter((b.weight for b in ev), np.int64, n)
    sample = np.fromiter((b.sample for b in ev), np.int64, n)
    split = np.fromiter((b.is_split for b in ev), np.int64, n)
    w_tot = np.zeros(C, np.int64)
    sr_tot = np.zeros(C, np.int64)
    np.add.at(w_tot, cids, weight)
    np.add.at(sr_tot, cids, weight * split)
    M = int(sample.max()) + 1
    per_sample = np.zeros((C, M), np.int64)
    np.add.at(per_sample, (cids, sample), weight)
    first = np.full(C, n, np.int64)
    np.minimum.at(first, cids, np.arange(n))

    calls: List[SVCall] = []
    for c in range(C):
        if per_sample[c].max() < min_weight:
            continue
        b0 = ev[int(first[c])]
        svtype = b0.svtype
        pos1, pos2 = int(cc.pos[0][c]), int(cc.pos[1][c])
        ci1 = tuple(int(x) for x in cc.ci[0][c])
        ci2 = tuple(int(x) for x in cc.ci[1][c])
        ci195 = tuple(int(x) for x in cc.ci95[0][c])
        ci295 = tuple(int(x) for x in cc.ci95[1][c])
        nz1a, nz1b = (int(x) for x in cc.nz[0][c])
        nz2a, nz2b = (int(x) for x in cc.nz[1][c])
        pr1 = cc.prob[0][c, nz1a : nz1b + 1].astype(np.float64)
        pr2 = cc.prob[1][c, nz2a : nz2b + 1].astype(np.float64)
        pr1 = pr1 / max(pr1.sum(), 1e-30)
        pr2 = pr2 / max(pr2.sum(), 1e-30)
        if svtype != BND and pos2 < pos1:
            pos1, pos2 = pos2, pos1
            ci1, ci2 = ci2, ci1
            ci195, ci295 = ci295, ci195
            pr1, pr2 = pr2, pr1
        w = int(w_tot[c])
        sr = int(sr_tot[c])
        ss = {int(s): int(per_sample[c, s])
              for s in np.nonzero(per_sample[c])[0]}
        calls.append(SVCall(
            svtype=svtype, tid1=b0.tid1, pos1=pos1, strand1=b0.strand1,
            cipos=ci1, cipos95=ci195, prpos=pr1,
            tid2=b0.tid2, pos2=pos2, strand2=b0.strand2,
            ciend=ci2, ciend95=ci295, prend=pr2,
            su=w, pe=w - sr, sr=sr, sample_support=ss,
            imprecise=(sr == 0),
        ))
    calls.sort(key=lambda c: (c.tid1, c.pos1, c.tid2, c.pos2))
    return calls


def _cluster_breakpoints_host(
    evidence: List[Breakpoint],
    min_weight: int = 4,
    trim: float = 0.0,
) -> List[SVCall]:
    groups: Dict[Tuple, List[Breakpoint]] = {}
    for bp in evidence:
        groups.setdefault(
            (bp.svtype, bp.tid1, bp.tid2, bp.strand1, bp.strand2), []
        ).append(bp)
    calls: List[SVCall] = []
    for key, items in groups.items():
        svtype, tid1, tid2, s1, s2 = key
        items.sort(key=lambda b: b.start1)
        cluster: List[Breakpoint] = []

        def flush():
            if not cluster:
                return
            w = sum(b.weight for b in cluster)
            # lumpy -m is minimum weight within a single sample
            # (bin/speedseq:1242): pooled cross-sample evidence alone must
            # not produce a call no sample individually supports
            per_sample: Dict[int, int] = {}
            for b in cluster:
                per_sample[b.sample] = per_sample.get(b.sample, 0) + b.weight
            if max(per_sample.values()) < min_weight:
                return
            pos1, ci1, ci195, pr1 = _combine(
                [(b.start1, b.prob1) for b in cluster], trim=trim
            )
            pos2, ci2, ci295, pr2 = _combine(
                [(b.start2, b.prob2) for b in cluster], trim=trim
            )
            if svtype != BND and pos2 < pos1:
                pos1, pos2 = pos2, pos1
                ci1, ci2 = ci2, ci1
                ci195, ci295 = ci295, ci195
                pr1, pr2 = pr2, pr1
            sr = sum(b.weight for b in cluster if b.is_split)
            pe = w - sr
            ss: Dict[int, int] = {}
            for b in cluster:
                ss[b.sample] = ss.get(b.sample, 0) + b.weight
            calls.append(
                SVCall(
                    svtype=svtype, tid1=tid1, pos1=pos1, strand1=s1,
                    cipos=ci1, cipos95=ci195, prpos=pr1,
                    tid2=tid2, pos2=pos2, strand2=s2,
                    ciend=ci2, ciend95=ci295, prend=pr2,
                    su=w, pe=pe, sr=sr, sample_support=ss,
                    imprecise=(sr == 0),
                )
            )

        cur_end1 = cur_lo2 = cur_hi2 = None
        for b in cluster_order(items):
            e1 = b.start1 + len(b.prob1)
            lo2, hi2 = b.start2, b.start2 + len(b.prob2)
            if (
                cluster
                and b.start1 < cur_end1
                and lo2 < cur_hi2
                and hi2 > cur_lo2
            ):
                cluster.append(b)
                cur_end1 = max(cur_end1, e1)
                cur_lo2 = min(cur_lo2, lo2)
                cur_hi2 = max(cur_hi2, hi2)
            else:
                flush()
                cluster = [b]
                cur_end1, cur_lo2, cur_hi2 = e1, lo2, hi2
        flush()
    calls.sort(key=lambda c: (c.tid1, c.pos1, c.tid2, c.pos2))
    return calls


def cluster_order(items: List[Breakpoint]) -> List[Breakpoint]:
    return sorted(items, key=lambda b: (b.start1, b.start2))
