"""The plain reference's judgement of one ``var`` or ``somatic`` job: its
VCF and tabix index, read back with ``bgzf.py``, held to the planted
variants and to a pileup and genotype likelihoods recomputed here from
the job's BAMs.

- ``order_errors``: records out of coordinate order.
- ``index_errors``: records that a TBI query over a region finds where a
  scan of the file does not, or misses (regions drawn from the seed).
- ``count_errors``: isolated biallelic SNV records (no other record or
  planted variant within ``ISOLATION`` bp) where a sample's ``DP``, ``RO``
  or ``AO`` differs from this pileup's: primary, non-duplicate,
  non-supplementary mapped reads of MAPQ >= 1 whose aligned base there
  has base quality >= 3 (freebayes' default read and base filters).
- ``gl_gap``: the widest gap, over those records and samples, between
  the record's ``GL`` and the diploid likelihoods of this pileup,
  log10 sum over reads of (P(read | a1) + P(read | a2)) / 2 with
  P = 1 - e on the read's allele and e / 3 otherwise, e from the base
  quality (capped at 60), normalised to their maximum; in float64.
  ``control`` computes them in bfloat16 and puts them in the program's
  place: the lower precision a later change might take.
- ``missed_easy``: planted SNVs outside every repeat copy, isolated, at
  which this pileup of the calling sample (the tumour for ``somatic``)
  shows at least 4 alternate reads, at least a quarter of its depth, and
  at least 2 alternate reads on each half of the read, 10 bases clear of
  its middle (upstream's ``RPL > 0 && RPR > 0`` filter,
  bin/speedseq:709), and, for ``somatic``, no alternate read in the
  normal (upstream's somatic filter, bin/speedseq:155-186, drops a
  record whose normal is not called 0/0), and that no record carries.
- ``germline_pass`` (somatic): records that PASS at a planted germline
  site that the normal's pileup shows clearly: at least 4 reads, and a
  quarter of those over the site, carry the germline allele (an SNV's
  base, or an indel of its length right after the anchor).  Upstream's
  filter keys on the normal's genotype (bin/speedseq:155-186), so a site
  the normal's reads do not show cannot be held against the caller."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import bgzf
from .align_check import CODE, FDUP, FSECONDARY, FSUPP, FUNMAP

ISOLATION = 20
MIN_MAPQ, MIN_BASEQ = 1, 3


class Pileup:
    """Per-site read observations of one BAM, from its own records."""

    def __init__(self, path: str):
        self.bam = bgzf.read_bam(path)
        b = self.bam
        keep = (((b.flag & (FUNMAP | FSECONDARY | FDUP | FSUPP)) == 0)
                & (b.mapq >= MIN_MAPQ) & (b.tid >= 0))
        self.rows = np.nonzero(keep)[0]
        self.pos = b.pos[self.rows].astype(np.int64)
        self.end = self.pos + b.reflen[self.rows]
        self.key = b.tid[self.rows].astype(np.int64) * (1 << 32) + self.pos
        self.max_span = int(b.reflen[self.rows].max()) if len(
            self.rows) else 0
        self._cache = {}

    def _read(self, i: int):
        hit = self._cache.get(i)
        if hit is None:
            b = self.bam
            seq = CODE[np.frombuffer(bgzf.record_seq(b, i).encode(),
                                     np.uint8)]
            o = int(b.off[i]) + 36 + b.data[int(b.off[i]) + 12] + 4 * len(
                b.cigars[i]) + (int(b.l_seq[i]) + 1) // 2
            qual = np.frombuffer(b.data[o:o + int(b.l_seq[i])], np.uint8)
            hit = self._cache[i] = (seq, qual)
        return hit

    def at(self, tid: int, pos0: int) -> List[Tuple[int, int, int, int]]:
        """(base code, base quality, offset in the read, read length) of
        each read aligned at ``pos0``."""
        base = tid * (1 << 32)
        lo = np.searchsorted(self.key, base + pos0 - self.max_span, "left")
        hi = np.searchsorted(self.key, base + pos0, side="right")
        out = []
        for j in range(lo, hi):
            if self.end[j] <= pos0:
                continue
            i = int(self.rows[j])
            ri, qi = int(self.pos[j]), 0
            for op, n in self.bam.cigars[i]:
                if op in "M=X":
                    if ri <= pos0 < ri + n:
                        seq, qual = self._read(i)
                        k = qi + pos0 - ri
                        if qual[k] >= MIN_BASEQ:
                            out.append((int(seq[k]), int(qual[k]), k,
                                        len(seq)))
                        break
                    ri += n
                    qi += n
                elif op in "IS":
                    qi += n
                elif op in "DN":
                    if ri <= pos0 < ri + n:
                        break
                    ri += n
        return out


    def allele_reads(self, tid: int, pos0: int, ref_a: str,
                     alt_a: str) -> Tuple[int, int]:
        """(reads carrying the allele, reads over the site) of a VCF-style
        biallelic variant at ``pos0``: an SNV's base, or an indel of its
        length starting right after the anchor base."""
        if len(ref_a) == len(alt_a) == 1:
            obs = self.at(tid, pos0)
            return sum(o[0] == CODE[ord(alt_a)] for o in obs), len(obs)
        op_want = "I" if len(alt_a) > len(ref_a) else "D"
        n_want = abs(len(alt_a) - len(ref_a))
        base = tid * (1 << 32)
        lo = np.searchsorted(self.key, base + pos0 - self.max_span, "left")
        hi = np.searchsorted(self.key, base + pos0, side="right")
        support = depth = 0
        for j in range(lo, hi):
            if self.end[j] <= pos0 + 1:
                continue
            depth += 1
            ri = int(self.pos[j])
            for op, n in self.bam.cigars[int(self.rows[j])]:
                if ri > pos0 + 1:
                    break
                if op == op_want and n == n_want and ri == pos0 + 1:
                    support += 1
                    break
                if op in "M=XDN":
                    ri += n
        return support, depth


def likelihoods(obs: Sequence[tuple], ref: int, alt: int,
                dtype=torch.float64) -> np.ndarray:
    """Max-normalised log10 likelihoods of 0/0, 0/1, 1/1."""
    if not obs:
        return np.zeros(3)
    b = torch.tensor([o[0] for o in obs])
    q = torch.tensor([min(o[1], 60) for o in obs], dtype=torch.float64)
    e = torch.pow(10.0, -q / 10.0)
    p_ref = torch.where(b == ref, 1 - e, e / 3).to(dtype)
    p_alt = torch.where(b == alt, 1 - e, e / 3).to(dtype)
    half = torch.tensor(0.5, dtype=dtype)
    terms = torch.stack([torch.log10(p_ref), torch.log10(
        half * p_ref + half * p_alt), torch.log10(p_alt)], 1)
    gl = torch.zeros(3, dtype=dtype)
    for t in terms:                 # in read order, in ``dtype``
        gl = gl + t
    gl = gl - gl.max()
    return gl.double().numpy()


def check_var(vcf_path: str, bams: Sequence[str], contigs: List[np.ndarray],
              names: List[str], repeat: List[np.ndarray],
              germline: Sequence[Tuple[int, int, str, str]],
              somatic: Sequence[Tuple[int, int, str, str]],
              region: Tuple[int, int, int], rng, n_regions: int = 16,
              control: bool = False) -> Dict[str, float]:
    """Judge one job's VCF.  ``germline``/``somatic`` hold planted
    variants as (contig index, 0-based position, ref, alt); ``region``
    is (contig index, start, end) of the job's windows; ``bams`` are in
    the VCF's sample order (normal first for somatic)."""
    out: Dict[str, float] = {}
    samples, recs, vo = bgzf.read_vcf(vcf_path)
    tid_of = {n: i for i, n in enumerate(names)}
    key = np.array([tid_of.get(r.chrom, len(names)) * (1 << 32) + r.pos
                    for r in recs], np.int64)
    out["order_errors"] = int((np.diff(key) < 0).sum())
    seqnames, index = bgzf.read_tbi(vcf_path + ".tbi")
    idx_err = 0
    r_tid = np.array([seqnames.index(r.chrom) if r.chrom in seqnames
                      else -1 for r in recs], np.int64)
    r_beg = np.array([r.pos - 1 for r in recs], np.int64)
    r_end = r_beg + np.array([len(r.ref) for r in recs], np.int64)
    t0, lo0, hi0 = region
    for _ in range(n_regions):
        t = seqnames.index(names[t0]) if names[t0] in seqnames else 0
        beg = int(rng.integers(lo0, hi0))
        end = beg + int(rng.integers(1, 100_000))
        want = np.nonzero((r_tid == t) & (r_beg < end) & (r_end > beg))[0]
        got = bgzf.query_hits(index, t, beg, end, vo)
        got = got[(r_tid[got] == t) & (r_beg[got] < end) & (r_end[got] > beg)]
        idx_err += len(np.setxor1d(want, got))
    out["index_errors"] = idx_err

    piles = [Pileup(p) for p in bams]
    planted = sorted([(t, p) for t, p, _, _ in list(germline) + list(
        somatic)])
    planted_pos = {}
    for t, p in planted:
        planted_pos.setdefault(t, []).append(p)
    for t in planted_pos:
        planted_pos[t] = np.asarray(planted_pos[t], np.int64)
    rec_pos = {}
    for r in recs:
        rec_pos.setdefault(tid_of.get(r.chrom, -1), []).append(r.pos - 1)
    for t in rec_pos:
        rec_pos[t] = np.sort(np.asarray(rec_pos[t], np.int64))

    def n_near(table, t, p):
        a = table.get(t)
        if a is None:
            return 0
        return int(np.searchsorted(a, p + ISOLATION, side="right")
                   - np.searchsorted(a, p - ISOLATION, side="left"))

    count_err, gap = 0, 0.0
    for r in recs:
        t = tid_of.get(r.chrom, -1)
        p = r.pos - 1
        if (t < 0 or len(r.ref) != 1 or len(r.alt) != 1
                or len(r.alt[0]) != 1 or n_near(rec_pos, t, p) != 1
                or n_near(planted_pos, t, p) > 1):
            continue
        ref, alt = int(CODE[ord(r.ref)]), int(CODE[ord(r.alt[0])])
        for s, pile in enumerate(piles):
            obs = pile.at(t, p)
            ro = sum(o[0] == ref for o in obs)
            ao = sum(o[0] == alt for o in obs)
            rs = r.samples[s]
            if (int(rs["DP"]), int(rs["RO"]), int(rs["AO"])) != (
                    ro + ao, ro, ao):
                count_err += 1
                continue
            want = likelihoods([o for o in obs if o[0] in (ref, alt)],
                               ref, alt)
            if control:
                have = likelihoods([o for o in obs if o[0] in (ref, alt)],
                                   ref, alt, torch.bfloat16)
            else:
                have = np.array([float(x) for x in rs["GL"].split(",")])
            gap = max(gap, float(np.abs(have - want).max()))
    out["count_errors"] = count_err
    out["gl_gap"] = gap

    called = {(tid_of.get(r.chrom, -1), r.pos - 1, r.ref[0], a[0])
              for r in recs for a in r.alt if len(r.ref) == len(a)}
    called |= {(tid_of.get(r.chrom, -1), r.pos - 1 + j, r.ref[j], a[j])
               for r in recs for a in r.alt if len(r.ref) == len(a)
               for j in range(len(a)) if r.ref[j] != a[j]}
    truth = somatic if len(bams) > 1 else germline
    calling = piles[-1]
    missed, details = 0, []
    for t, p, ref_a, alt_a in truth:
        if (len(ref_a) != 1 or len(alt_a) != 1 or not lo0 + 200 <= p
                < hi0 - 200 or t != t0 or repeat[t][p]
                or n_near(planted_pos, t, p) > 1):
            continue
        obs = calling.at(t, p)
        alt = int(CODE[ord(alt_a)])
        alts = [(k, n) for b, _, k, n in obs if b == alt]
        left = sum(k < n / 2 - 10 for k, n in alts)
        right = sum(k >= n / 2 + 10 for k, n in alts)
        clean = len(bams) == 1 or not any(
            o[0] == alt for o in piles[0].at(t, p))
        if (len(alts) >= 4 and 4 * len(alts) >= len(obs) and left >= 2
                and right >= 2 and clean
                and (t, p, ref_a, alt_a) not in called):
            missed += 1
            details.append(f"missed {names[t]}:{p + 1} {ref_a}>{alt_a}: "
                           f"{len(alts)} of {len(obs)} reads, {left} left "
                           f"{right} right")
    out["missed_easy"] = missed
    out["details"] = details[:8]
    if len(bams) > 1:
        germ = {(t, p): (ref_a, alt_a) for t, p, ref_a, alt_a in germline}
        leaks = 0
        for r in recs:
            t, p = tid_of.get(r.chrom, -1), r.pos - 1
            if r.filter != "PASS" or (t, p) not in germ:
                continue
            pr, pa = germ[(t, p)]
            sup, dep = map(int, piles[0].allele_reads(t, p, pr, pa))
            clear = sup >= 4 and 4 * sup >= dep
            leaks += int(clear)
            verdict = "counted" if clear else "not clear, not counted"
            fields = [":".join(str(x.get(k, ".")) for k in (
                "GT", "DP", "RO", "AO")) for x in r.samples]
            details.append(
                f"germline PASS {r.chrom}:{r.pos} {r.ref}>{','.join(r.alt)}"
                f" (planted {pr}>{pa}, repeat {bool(repeat[t][p])}, SSC "
                f"{r.info.get('SSC')}; GT:DP:RO:AO normal {fields[0]}, "
                f"tumour {fields[1]}; the normal's pileup shows it in {sup} "
                f"of {dep} reads: {verdict})")
        out["germline_pass"] = leaks
        out["details"] = details[:8]
    return out
