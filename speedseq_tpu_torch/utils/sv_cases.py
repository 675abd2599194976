"""Seeded inputs for sv, shared by the CPU tests (port vs the JAX
package), the card tests (cuda vs cpu) and chip_smoke.py.

- ``random_evidence``: random LUMPY evidence over two contigs, all four
  SV types, two samples (the generator of tests/test_sv.py:337-358);
- ``pile_evidence``: one cluster of n overlapping DEL rows;
- ``combine_edge_cases``: inputs of the curve combination's member
  log-sum at the edges of its kernel's chunks and tiles;
- ``sweep_columns``: sorted cluster-sweep inputs (gid, s1, e1, lo2, hi2)
  for the named shapes the sweep must handle, including two synthetic
  shapes of 1,048,576 rows: 16 uniform groups (the worst case for one
  thread per group) and 256 skewed groups with piles (a guessed
  distribution, from no real evidence set); ``sweep_adversarial``:
  inputs at the edges of the kernel's forced-break split;
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


# (cluster sizes, W, D) of combine_edge_cases; on a card of 132 SMs the
# kernel takes column tiles of 8, 16, 32, 64 and 128 columns (chunks of
# 496, 248, 124, 60 and 4 members), the pile tiles of 8; each case has
# clusters at K - 1, K and K + 1 members, an empty one and one of 3 K + 1
# (four chunks fill the kernel's three-stage pipeline)
COMBINE_EDGES = {
    "tile-8": ([495, 496, 497, 0, 1489, 1], 100, 90),
    "tile-16": ([247, 248, 249, 0, 745], 300, 120),
    "tile-32": ([123, 124, 125, 0, 373], 600, 64),
    "tile-64": ([59, 60, 61, 0, 181], 900, 120),
    "tile-128": ([3, 4, 5, 0, 13] + [1 + (7 * k) % 40 for k in range(65)],
                 300, 64),
    "pile-4096": ([4096], 256, 100),
}


def combine_edge_cases(name: str, seed: int = 0):
    """(first, sizes, lo, start, clen, curves, W) of the member log-sum
    (``ops/sv_combine.py:combine_logsum``), numpy int32 / float32, for
    the COMBINE_EDGES case ``name``: members in row order, a cluster's
    starts from a little before its lo to past W, lengths 0..D, curve
    values uniform in [0.001, 1) but 24 cells inside their curves and W,
    three each of NaN, 0, negative, inf, denormal, 1e-13, 1e-12 and
    2e-12."""
    sizes, W, D = COMBINE_EDGES[name]
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    C, n = len(sizes), int(sizes.sum())
    first = (np.cumsum(sizes) - sizes).astype(np.int32)
    lo = (1000 + 37 * np.arange(C)).astype(np.int32)
    cid = np.repeat(np.arange(C), sizes)
    start = (lo[cid] + rng.integers(-5, W, n)).astype(np.int32)
    clen = rng.integers(0, D + 1, n).astype(np.int32)
    curves = rng.uniform(0.001, 1.0, (n, D)).astype(np.float32)
    odd = np.array([np.nan, 0.0, -0.5, np.inf, 1e-40, 1e-13, 1e-12, 2e-12],
                   np.float32)
    # the odd cells lie inside their member's curve and inside W
    rows, cols = rng.integers(0, n, 24), rng.integers(0, min(D, W // 2), 24)
    start[rows] = lo[cid[rows]] + rng.integers(0, W // 2, 24)
    clen[rows] = np.maximum(clen[rows], cols + 1)
    curves[rows, cols] = odd[np.arange(24) % len(odd)]
    return first, sizes, lo, start, clen, curves, W


SWEEP_SHAPES = ("random", "one-row", "one-group", "one-row-groups", "genome",
                "genome-piles")


def sweep_columns(shape: str, seed: int = 0):
    """(gid, s1, e1, lo2, hi2) int32 numpy columns sorted by (gid, s1,
    lo2).  Both 1,048,576-row shapes are synthetic.  ``genome`` is 16
    groups spread uniformly over 200 Mbp each, almost all singletons: the
    worst case for one thread per group, not a genome's evidence.
    ``genome-piles`` is 256 groups of skewed sizes (weights 1/k^0.75: the
    largest ~8 %), 90 % of each group scattered over 200 Mbp and 10 % in
    piles of 64-4,096 mutually overlapping rows: a guessed distribution,
    with no real evidence set behind its group or pile sizes."""
    if shape == "genome-piles":
        return _genome_piles(seed)
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
    return _sorted(gid, s1, s1 + l1, lo2, lo2 + l2)


def _sorted(gid, s1, e1, lo2, hi2):
    order = np.lexsort((lo2, s1, gid))
    return tuple(np.asarray(c)[order].astype(np.int32)
                 for c in (gid, s1, e1, lo2, hi2))


def _genome_piles(seed: int, n: int = 1 << 20, groups: int = 256,
                  span: int = 200_000_000):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, groups + 1) ** 0.75
    sizes = np.floor(n * w / w.sum()).astype(np.int64)
    sizes[: n - sizes.sum()] += 1
    cols = [[] for _ in range(5)]
    for g, size in enumerate(sizes):
        piles, left = [], int(size) // 10
        while left >= 64:
            piles.append(min(left, int(rng.integers(64, 4097))))
            left -= piles[-1]
        k = int(size) - sum(piles)             # the scattered rows
        s1 = rng.integers(0, span, k)
        l1 = rng.integers(20, 600, k)
        lo2 = s1 + rng.integers(300, 5000, k)
        l2 = rng.integers(20, 600, k)
        parts = [(s1, s1 + l1, lo2, lo2 + l2)]
        for m in piles:   # every side contains [c + 60, c + 70): one cluster
            c = int(rng.integers(0, span))
            ps1 = c + rng.integers(0, 60, m)
            plo2 = c + 500 + rng.integers(0, 60, m)
            parts.append((ps1, ps1 + rng.integers(70, 100, m), plo2,
                          plo2 + rng.integers(70, 100, m)))
        cols[0].append(np.full(int(size), g))
        for i in range(4):
            cols[i + 1].append(np.concatenate([p[i] for p in parts]))
    return _sorted(*(np.concatenate(c) for c in cols))


def sweep_adversarial():
    """Named sweep inputs at the edges of the forced-break split (sorted
    like ``sweep_columns``'s): a gid change after a huge end1, end1 at
    both int32 limits, start1 equal to and one below the largest earlier
    end1 of its gid (P), and single-row segments among longer ones."""
    big, small = 2**31 - 1, -(2**31)
    rows = {
        # gid 0 ends at INT32_MAX; gid 1's rows start below it
        "gid change after a huge end1": [
            (0, 5, big, 10, 20), (1, 6, 9, 10, 20), (1, 7, 12, 10, 20),
            (2, 0, 3, 10, 20)],
        "end1 at both int32 limits": [
            (0, small, small, small, small + 5), (0, small, small + 1,
                                                   small, small + 5),
            (0, small + 1, big, small + 1, small + 9),
            (0, big - 1, big, small + 2, small + 8),
            (0, big - 1, big, big - 5, big), (1, small, small, 0, 1),
            (1, small, big, 0, 1), (1, 0, 0, 0, 1)],
        # s1 = P - 1 is tested (it overlaps, or not), s1 = P is forced
        "s1 at P and one below": [
            (0, 10, 100, 0, 50), (0, 99, 100, 10, 40), (0, 100, 130, 10, 40),
            (0, 129, 140, 10, 40), (0, 140, 150, 10, 40),
            (1, 10, 100, 0, 50), (1, 99, 100, 60, 70), (1, 100, 110, 0, 5),
            # P = 100 from a closed cluster: s1 = 99 fails the test
            (2, 0, 100, 0, 5), (2, 50, 60, 90, 95), (2, 59, 70, 90, 95),
            (2, 99, 100, 0, 5), (2, 100, 101, 0, 5)],
        "single-row segments": [
            (0, 5, 10, 0, 3), (1, 0, 50, 0, 3), (1, 1, 2, 1, 2),
            (2, 7, 8, 0, 9), (3, 0, 9, 0, 9), (3, 8, 9, 8, 9), (4, 1, 2, 3, 4)],
    }
    return {name: _sorted(*np.asarray(r, np.int64).T)
            for name, r in rows.items()}


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
