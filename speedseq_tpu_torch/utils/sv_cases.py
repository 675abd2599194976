"""Seeded inputs for sv, shared by the CPU tests (port vs the JAX
package), the card tests (cuda vs cpu) and chip_smoke.py.

- ``random_evidence``: random LUMPY evidence over two contigs, all four
  SV types, two samples (the generator of tests/test_sv.py:337-358);
- ``pile_evidence``: one cluster of n overlapping DEL rows;
- ``sweep_columns``: sorted cluster-sweep inputs (gid, s1, e1, lo2, hi2)
  for the named shapes the sweep must handle, including a genome's row
  count in 16 groups (the worst case for one thread per group);
- ``unmapped_tail_bam`` / ``depth_tier_bam``: the SVTyper fixtures of
  tests/test_sv.py:457-568 (a BAM with an unmapped tail; one breakpoint at
  50x the depth of eight others), each with its calls;
- ``abrupt_profile``: the mean-shift fixture of tests/test_sv.py:431-454;
- ``apply_events`` / ``plant_svs``: a sample haplotype carrying
  deletions, tandem duplications and inversions (and a reciprocal
  translocation between two contigs) with its truth.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..formats.bam import BAMWriter
from ..formats.sam import SAMHeader, SAMRecord
from ..sv.evidence import BND, DEL, DUP, INV, Breakpoint


def random_evidence(rng: np.random.Generator, n: int, n_samples: int = 2,
                    n_tids: int = 2) -> List[Breakpoint]:
    types = [DEL, DUP, INV, BND]
    out = []
    for _ in range(n):
        svtype = types[int(rng.integers(0, 4))]
        tid1 = int(rng.integers(0, n_tids))
        tid2 = tid1 if svtype != BND else int(rng.integers(0, n_tids))
        d1 = int(rng.integers(5, 40))
        d2 = int(rng.integers(5, 40))
        p1 = rng.uniform(0.05, 1.0, d1)
        p2 = rng.uniform(0.05, 1.0, d2)
        base = int(rng.integers(0, 4000))
        out.append(Breakpoint(
            svtype=svtype, tid1=tid1, strand1=int(rng.integers(0, 2)),
            start1=base + int(rng.integers(0, 60)), prob1=p1 / p1.sum(),
            tid2=tid2, strand2=int(rng.integers(0, 2)),
            start2=base + 500 + int(rng.integers(0, 60)),
            prob2=p2 / p2.sum(),
            weight=1, sample=int(rng.integers(0, n_samples)),
            is_split=bool(rng.integers(0, 2)),
        ))
    return out


def pile_evidence(rng: np.random.Generator, n: int) -> List[Breakpoint]:
    """n DEL rows of one sample whose sides all overlap: one cluster of n
    members, the pile-up that evidence forms at a breakpoint."""
    out = []
    for _ in range(n):
        p1 = rng.uniform(0.05, 1.0, int(rng.integers(70, 100)))
        p2 = rng.uniform(0.05, 1.0, int(rng.integers(70, 100)))
        out.append(Breakpoint(
            svtype=DEL, tid1=0, strand1=0,
            start1=1000 + int(rng.integers(0, 60)), prob1=p1 / p1.sum(),
            tid2=0, strand2=1, start2=1500 + int(rng.integers(0, 60)),
            prob2=p2 / p2.sum(), weight=1, sample=0,
            is_split=bool(rng.integers(0, 2)),
        ))
    return out


SWEEP_SHAPES = ("random", "one-row", "one-group", "one-row-groups", "genome")


def sweep_columns(shape: str, seed: int = 0):
    """(gid, s1, e1, lo2, hi2) int32 numpy columns sorted by (gid, s1,
    lo2).  ``genome`` is 1,048,576 rows (a genome's evidence count) in 16
    groups spread uniformly over 200 Mbp each, almost all singletons: the
    worst case for one thread per group, not a genome's traffic, whose
    hundreds to thousands of (svtype, tid1, tid2, strand1, strand2) groups
    pile up at breakpoints."""
    rng = np.random.default_rng(seed)
    n, groups, span = {"random": (3000, 12, 40_000),
                       "one-row": (1, 1, 1000),
                       "one-group": (2000, 1, 60_000),
                       "one-row-groups": (500, 500, 10_000),
                       "genome": (1 << 20, 16, 200_000_000)}[shape]
    if shape == "one-row-groups":
        gid = np.arange(n)
    else:
        gid = rng.integers(0, groups, n)
    s1 = rng.integers(0, span, n)
    l1 = rng.integers(20, 600, n)
    lo2 = s1 + rng.integers(300, 5000, n)
    l2 = rng.integers(20, 600, n)
    order = np.lexsort((lo2, s1, gid))
    cols = (gid, s1, s1 + l1, lo2, lo2 + l2)
    return tuple(c[order].astype(np.int32) for c in cols)


def _crossing(name, p, flag=0x1 | 0x2 | 0x20):
    return SAMRecord(
        qname=name, flag=flag, tid=0, pos=p, mapq=60, cigar=[(0, 100)],
        mtid=0, mpos=p + 200, tlen=300, seq="A" * 100, qual="I" * 100)


def _del_call(pos: int, end: int) -> Dict:
    """The fields of an imprecise DEL call (an SVCall's keyword args)."""
    return dict(svtype=DEL, tid1=0, pos1=pos, strand1=0, cipos=(0, 0),
                cipos95=(0, 0), prpos=np.ones(1), tid2=0, pos2=end,
                strand2=1, ciend=(0, 0), ciend95=(0, 0), prend=np.ones(1),
                su=4, pe=4, sr=0, sample_support={0: 4}, imprecise=True)


def unmapped_tail_bam(path: str) -> List[Dict]:
    """Clean crossings over a DEL breakpoint at 5000, then an unmapped
    tail (tid = pos = -1, as samtools sort places it)."""
    hdr = SAMHeader(text="@SQ\tSN:c\tLN:100000\n", refs=[("c", 100000)])
    recs = [_crossing(f"m{i}", 4950 + i * 4) for i in range(12)]
    recs += [SAMRecord(
        qname=f"u{i}", flag=0x4 | 0x8 | 0x1, tid=-1, pos=-1, mapq=0,
        cigar=[], mtid=-1, mpos=-1, tlen=0, seq="C" * 50, qual="#" * 50)
        for i in range(6)]
    with BAMWriter(path, hdr) as w:
        w.write_batch(recs)
    return [_del_call(5000, 7000)]


def depth_tier_bam(path: str) -> List[Dict]:
    """Eight breakpoints with 12 crossings each and one with 600."""
    hdr = SAMHeader(text="@SQ\tSN:c\tLN:2000000\n", refs=[("c", 2000000)])
    recs = []
    centers = [100_000 + k * 50_000 for k in range(8)] + [900_000]
    for k, c in enumerate(centers):
        depth = 600 if k == 8 else 12
        recs += [_crossing(f"n{k}_{i}", c - 50 + (i % 20) * 4)
                 for i in range(depth)]
    recs.sort(key=lambda r: r.pos)
    with BAMWriter(path, hdr) as w:
        w.write_batch(recs)
    return [_del_call(c, c + 2000) for c in centers]


def abrupt_profile(seed: int = 7) -> Tuple[np.ndarray, float]:
    """400 bins at mean depth 100 with a CN 1 segment over bins 150-249."""
    rng = np.random.default_rng(seed)
    mean = 100.0
    depth = np.full(400, mean)
    depth[150:250] = 50.0
    return rng.poisson(depth).astype(np.float64), mean


def apply_events(seq: np.ndarray, events, lo: int, hi: int) -> np.ndarray:
    """seq[lo:hi] with the events (kind, start, length) inside it applied:
    DEL removes, DUP repeats in tandem, INV reverse-complements."""
    out, cur = [], lo
    for kind, p, ln in sorted((e for e in events if lo <= e[1] < hi),
                              key=lambda e: e[1]):
        out.append(seq[cur:p])
        piece = seq[p:p + ln]
        if kind == INV:
            out.append(3 - piece[::-1])
        elif kind == DUP:
            out += [piece, piece]
        cur = p + ln
    out.append(seq[cur:hi])
    return np.concatenate(out).astype(np.uint8)


def plant_svs(lengths: Tuple[int, int], rng: np.random.Generator,
              n_del: int = 8, n_dup: int = 4, n_inv: int = 4,
              margin: int = 20_000):
    """Two random contigs and their alternate haplotypes: deletions of
    1-5 kb, tandem duplications and inversions of 1-3 kb, spread over both
    contigs in proportion to length, and a reciprocal translocation that
    joins contig 0 at ``ta`` to contig 1 at ``tb`` (both alternate contigs
    are chimeric).  Returns (contigs, alternates, events, (ta, tb)) with
    events as (kind, tid, start, length) in reference coordinates."""
    contigs = [rng.integers(0, 4, n).astype(np.uint8) for n in lengths]
    ta, tb = lengths[0] // 2 + 1234, lengths[1] // 2 + 567
    kinds = [DEL] * n_del + [DUP] * n_dup + [INV] * n_inv
    rng.shuffle(kinds)
    total = sum(lengths)
    per = [int(round(len(kinds) * n / total)) for n in lengths]
    per[0] = len(kinds) - per[1]
    events = []
    k = 0
    for tid, n in enumerate(lengths):
        cut = (ta, tb)[tid]
        slots = np.linspace(margin, n - margin, per[tid] + 2)[1:-1]
        for centre in slots:
            kind = kinds[k]
            k += 1
            ln = int(rng.integers(1000, 5001 if kind == DEL else 3001))
            start = int(centre) + int(rng.integers(-2000, 2000))
            if start < cut < start + ln + margin // 4:   # clear of the cut
                start = cut + margin // 4
            events.append((kind, tid, start, ln))
    ev = [[(k_, s, l) for k_, t, s, l in events if t == tid]
          for tid in range(2)]
    a, b = contigs
    alt_a = np.concatenate([apply_events(a, ev[0], 0, ta),
                            apply_events(b, ev[1], tb, len(b))])
    alt_b = np.concatenate([apply_events(b, ev[1], 0, tb),
                            apply_events(a, ev[0], ta, len(a))])
    return contigs, [alt_a, alt_b], events, (ta, tb)
