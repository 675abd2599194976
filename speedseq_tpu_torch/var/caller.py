"""Candidate alleles + genotype likelihoods + VCF records per window.

Bayesian haplotype-based genotyping in the FreeBayes mold [external
knowledge: Garrison & Marth 2012; the reference pins the CLI contract —
``--min-repeat-entropy 1`` at bin/speedseq:707, ``--pooled-discrete
--min-alternate-fraction .05 --min-alternate-count 2`` at :1059-1067 —
and the downstream filter fields QUAL / RPR / RPL at :709, GL and GT for
somatic at :155-186].

Model features matching the reference engine:
- **multi-allelic loci**: up to ``max_alts`` ALT alleles per record
  (NUMALT > 1), genotyped jointly over all diploid allele pairs in VCF
  canonical order.
- **haplotype windows**: candidate alleles within ``haplotype_gap`` bp
  are evaluated jointly over the spanned reference window; reads vote
  for the haplotype they actually carry, so adjacent SNVs on one
  haplotype emit as a single MNP/complex allele.
- **min-repeat-entropy**: indel allele windows grow rightward until the
  spanned reference sequence reaches ``min_repeat_entropy`` bits of
  Shannon entropy, so indels in (interrupted) repeats are represented
  and evaluated over the whole repeat tract.
- **per-sample input thresholds**: ``min_alternate_count/fraction``
  admit a site when ANY single sample passes (freebayes -C/-F
  semantics); ``pooled_discrete`` additionally emits sites whose best
  genotypes are all hom-ref so the somatic SSC filter sees marginal
  evidence.
- **posterior QUAL**: phred-scaled posterior probability that the site
  is polymorphic under a site-heterozygosity prior, not an ad-hoc GL
  delta.

GL math runs as one torch program over (site, read, genotype) tensors
on the run's device (var.device), and the haplotype scorer runs its
read-vs-haplotype DP there too (align.sw.banded_sw_score); everything
producing those inputs is vectorized numpy on the host.  ``device`` is
carried from the entry point through ``prepare_window`` and
``genotype_windows``: cuda unless the caller asks for cpu.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..formats.vcf import VCFRecord
from ..utils.metrics import metrics
from .normalize import left_align
from .pileup import WindowPileup

_BASES = "ACGT"

from .caller_space import GT_PAIRS as _GT_PAIRS
from .caller_space import MAX_ALTS as _MAX_ALTS
from .caller_space import N_GT as _N_GT


@dataclass(frozen=True)
class CallerConfig:
    min_alternate_count: int = 2      # freebayes -C
    min_alternate_fraction: float = 0.2  # freebayes -F (somatic: 0.05)
    min_mapq: int = 1
    min_baseq: int = 3
    indel_q: int = 25                 # observation quality for indel support
    pooled_discrete: bool = False     # somatic mode (bin/speedseq:1059)
    max_alts: int = _MAX_ALTS         # NUMALT cap per record
    haplotype_gap: int = 3            # join candidates within this many bp
    min_repeat_entropy: float = 1.0   # bits (bin/speedseq:707 pins 1)
    theta: float = 0.001              # site heterozygosity prior

    def __post_init__(self):
        # the genotype space (_GT_PAIRS, _gl_terms_multi, invalid-pair
        # mask) is built for _MAX_ALTS alts; a larger cap would silently
        # make allele _MAX_ALTS+1 ungenotypeable
        if self.max_alts > _MAX_ALTS:
            raise ValueError(
                f"max_alts={self.max_alts} exceeds the supported genotype "
                f"space ({_MAX_ALTS} alternate alleles)"
            )


class DeviceError(RuntimeError):
    """A torch device call of the var path failed.  The engine's
    per-window containment re-raises it: a device fault must fail the
    run, never become an empty window."""


def _gl_terms(support: torch.Tensor, quals: torch.Tensor) -> torch.Tensor:
    """Biallelic per-read diploid genotype log10-likelihood terms.

    support: (S, R) int8 — 1 = ref obs, 2 = alt obs, 0 = not covering
    quals:   (S, R) float32 phred
    returns (S, R, 3) float32 log10 P(read | RR/RA/AA); 0 for non-covering
    reads (so callers can segment-sum by sample).
    """
    e = torch.pow(10.0, -quals / 10.0)
    p_ref = torch.where(support == 1, 1.0 - e, e / 3.0)
    p_alt = torch.where(support == 2, 1.0 - e, e / 3.0)
    cover = (support > 0)[..., None]
    p = torch.stack([p_ref, 0.5 * p_ref + 0.5 * p_alt, p_alt], dim=-1)
    return torch.where(cover, torch.log10(p + 1e-30), 0.0)


def _gl_terms_multi(obs: torch.Tensor, quals: torch.Tensor) -> torch.Tensor:
    """Multi-allelic per-read genotype log10-likelihood terms.

    obs:   (S, R) int8 — -1 = not covering, 0 = ref, k = alt allele k
    quals: (S, R) float32 phred
    returns (S, R, G) float32 log10 P(read | genotype) over the
    ``_GT_PAIRS`` diploid genotypes; 0 for non-covering reads.
    """
    e = torch.pow(10.0, -quals / 10.0)
    alleles = torch.arange(_MAX_ALTS + 1, dtype=obs.dtype, device=obs.device)
    match = obs[..., None] == alleles                    # (S, R, A+1)
    p = torch.where(match, (1.0 - e)[..., None], (e / 3.0)[..., None])
    cover = (obs >= 0)[..., None]
    t = torch.stack(
        [torch.log10(0.5 * p[..., j] + 0.5 * p[..., k] + 1e-30)
         for j, k in _GT_PAIRS],
        dim=-1,
    )
    return torch.where(cover, t, 0.0)


def seq_entropy_bits(codes: np.ndarray) -> float:
    """Shannon entropy (bits) of the base composition of `codes`."""
    if len(codes) == 0:
        return 0.0
    cnt = np.bincount(np.minimum(codes, 4).astype(np.int64), minlength=5)[:4]
    tot = cnt.sum()
    if tot == 0:
        return 0.0
    p = cnt[cnt > 0] / tot
    return float(-(p * np.log2(p)).sum())


def repeat_extend(
    genome: np.ndarray, pos: int, ref_len: int,
    min_entropy: float, cap: int = 64,
) -> int:
    """freebayes ``--min-repeat-entropy``: grow the allele window right
    until the spanned reference has ≥ `min_entropy` bits of entropy, so
    indels in (interrupted) repeats are represented over the full tract.
    Returns the window end (absolute genome position)."""
    end = pos + ref_len
    if min_entropy <= 0:
        return end
    limit = min(len(genome), pos + cap)
    while end < limit and seq_entropy_bits(genome[pos:end]) < min_entropy:
        end += 1
    return end


@dataclass
class SiteCall:
    """One genotyped locus (possibly multi-allelic / haplotype)."""

    offset: int          # window offset of the first REF base
    ref: str
    alts: List[str]
    types: List[str]     # per alt: snp / mnp / ins / del / complex
    lengths: List[int]
    # per-sample arrays
    gt: np.ndarray       # (n_samples, 2) allele indices, j <= k
    gq: np.ndarray       # (n_samples,)
    gl: np.ndarray       # (n_samples, G) over valid genotype pairs
    dp: np.ndarray       # (n_samples,)
    ro: np.ndarray
    ao: np.ndarray       # (n_samples, A)
    qr: np.ndarray
    qa: np.ndarray       # (n_samples, A)
    qual: float
    # per-alt placement/strand balance
    rpl: np.ndarray      # (A,)
    rpr: np.ndarray
    saf: np.ndarray
    sar: np.ndarray

    # biallelic conveniences for existing consumers
    @property
    def alt(self) -> str:
        return self.alts[0]

    @property
    def type(self) -> str:
        return self.types[0]

    @property
    def length(self) -> int:
        return self.lengths[0]


def _allele_type(ref: str, alt: str) -> Tuple[str, int]:
    if len(ref) == 1 and len(alt) == 1:
        return "snp", 1
    if len(ref) == len(alt):
        return "mnp", len(alt)
    if len(ref) == 1 and alt.startswith(ref):
        return "ins", len(alt) - len(ref)
    if len(alt) == 1 and ref.startswith(alt):
        return "del", len(ref) - len(alt)
    return "complex", max(len(ref), len(alt))


def _collect_atoms(
    genome: np.ndarray, p: WindowPileup, n_samples: int, cfg: CallerConfig,
    sample_of_read: np.ndarray,
):
    """Atomic candidate alleles with per-sample -C/-F admission.

    Returns a list of dicts sorted by span start:
      snp:   kind, off, alt_code, span
      indel: kind, off (left-aligned emit offset), ref, alt, alt_reads,
             span (repeat-entropy extended)
    """
    L = p.end - p.start
    ref_codes = genome[p.start : p.end]
    atoms = []

    # ---- SNVs: pooled-count prefilter, then per-sample -C/-F ------------
    # per-sample admission is fully vectorized: one bincount over the
    # span-compact flat pileup yields (L, 5, M) sample-stratified base
    # counts, so no per-candidate p.col() gathers or per-sample Python
    # loops run (they were ~10% of somatic wall time at -F 0.05)
    counts = p.base_counts[:, :4]
    ref_safe = np.minimum(ref_codes, 3)
    alt_counts = counts.copy()
    alt_counts[np.arange(L), ref_safe] = 0
    M = n_samples
    spans = (p.rend - p.rstart).astype(np.int64)
    # two O(bases) int32 repeats (not three int64 ones): per-entry column
    # = arange + per-read offset; per-entry sample repeated directly
    off_r = (p.rstart.astype(np.int64) - p.base_idx).astype(np.int32)
    col_flat = (np.arange(len(p.flat_proj), dtype=np.int32)
                + np.repeat(off_r, spans))
    sam_flat = np.repeat(sample_of_read.astype(np.int32), spans)
    good = p.flat_proj >= 0
    fi = ((col_flat[good] * 5 + p.flat_proj[good]) * M + sam_flat[good])
    counts_sm = np.bincount(fi, minlength=L * 5 * M).reshape(L, 5, M)
    depth_sm = counts_sm.sum(axis=1)                       # (L, M)
    frac_ok = (counts_sm[:, :4]
               >= np.maximum(cfg.min_alternate_count,
                             np.ceil(cfg.min_alternate_fraction
                                     * depth_sm[:, None, :])))
    frac_ok &= depth_sm[:, None, :] > 0
    admit = frac_ok.any(axis=2)                            # (L, 4)
    admit &= alt_counts >= cfg.min_alternate_count
    admit[np.arange(L), ref_safe] = False
    admit &= (ref_codes < 4)[:, None]
    for off, alt_code in zip(*np.nonzero(admit)):
        atoms.append(
            dict(
                kind="snp", off=int(off), alt_code=int(alt_code),
                count=int(alt_counts[off, alt_code]),
                span=(int(off), int(off) + 1),
            )
        )

    # ---- indels ---------------------------------------------------------
    groups: Dict[Tuple[int, bool, int, str], List[int]] = {}
    for e in p.events:
        off = e.pos - p.start
        if 0 <= off < L:
            groups.setdefault((off, e.is_ins, e.length, e.seq), []).append(
                e.read_idx
            )
    raw = []
    for (off, is_ins, ln, seq), ridx in groups.items():
        anchor = ref_codes[off]
        if anchor >= 4:
            continue
        if is_ins:
            ref_al = _BASES[anchor]
            alt_al = ref_al + seq.upper()
        else:
            if off + ln >= L or (ref_codes[off : off + ln + 1] >= 4).any():
                continue
            ref_al = "".join(_BASES[c] for c in ref_codes[off : off + ln + 1])
            alt_al = _BASES[anchor]
        # canonical left-aligned representation (vt norm semantics)
        abs_pos, ref_n, alt_n = left_align(genome, p.start + off, ref_al, alt_al)
        raw.append(
            dict(
                off=abs_pos - p.start, ref=ref_n, alt=alt_n,
                alt_reads=set(ridx),
            )
        )
    # merge events normalizing to the same allele
    merged: Dict[Tuple, dict] = {}
    for c in raw:
        key = (c["off"], c["ref"], c["alt"])
        if key in merged:
            merged[key]["alt_reads"] |= c["alt_reads"]
        else:
            merged[key] = c
    for c in merged.values():
        ridx = c["alt_reads"]
        if len(ridx) < cfg.min_alternate_count:
            continue
        off = c["off"]
        if not (0 <= off < L):
            continue
        alt_read_mask = np.zeros(len(p.rstart), bool)
        for ri in ridx:
            alt_read_mask[ri] = True
        col, _, _ = p.col(off)
        covered = (col >= 0) | alt_read_mask
        ok = False
        for si in range(n_samples):
            m = sample_of_read == si
            ac = int((alt_read_mask & m).sum())
            dps = int((covered & m).sum())
            if ac >= cfg.min_alternate_count and dps > 0 and (
                ac / dps >= cfg.min_alternate_fraction
            ):
                ok = True
                break
        if not ok:
            continue
        span_end = repeat_extend(
            genome, p.start + off, len(c["ref"]), cfg.min_repeat_entropy
        ) - p.start
        span_end = min(span_end, L)
        atoms.append(
            dict(
                kind="indel", off=off, ref=c["ref"], alt=c["alt"],
                alt_reads=alt_read_mask, count=len(ridx),
                span=(off, max(span_end, off + len(c["ref"]))),
            )
        )
    atoms.sort(key=lambda a: (a["span"][0], a["span"][1], a["kind"]))
    return atoms


def _group_atoms(atoms: List[dict], gap: int) -> List[List[dict]]:
    """Cluster atoms whose spans fall within `gap` bp of each other
    (freebayes haplotype-window construction)."""
    out: List[List[dict]] = []
    cur: List[dict] = []
    cur_end = -(10 ** 9)
    for a in atoms:
        s, e = a["span"]
        if cur and s - cur_end < gap:
            cur.append(a)
            cur_end = max(cur_end, e)
        else:
            if cur:
                out.append(cur)
            cur = [a]
            cur_end = e
    if cur:
        out.append(cur)
    return out


@dataclass
class _Locus:
    """Pre-genotyping locus: alleles + per-read observations."""

    offset: int                  # window offset of first REF base
    ref: str
    alts: List[str]
    obs: np.ndarray              # (R,) int8 -1/0/1..A
    quals: np.ndarray            # (R,) float32
    anchor: int                  # representative offset for RPL/RPR


def _minimalize(offset: int, ref: str, alts: List[str]):
    """Trim shared suffix/prefix across REF and all ALTs (parsimony)."""
    # suffix
    while len(ref) > 1 and all(len(a) > 1 for a in alts) and all(
        a[-1] == ref[-1] for a in alts
    ):
        ref = ref[:-1]
        alts = [a[:-1] for a in alts]
    # prefix
    while len(ref) > 1 and all(len(a) > 1 for a in alts) and all(
        a[0] == ref[0] for a in alts
    ):
        ref = ref[1:]
        alts = [a[1:] for a in alts]
        offset += 1
    return offset, ref, alts


def _passes_per_sample(
    obs_alt: np.ndarray, obs_cov: np.ndarray,
    sample_of_read: np.ndarray, n_samples: int, cfg: CallerConfig,
) -> bool:
    for si in range(n_samples):
        m = sample_of_read == si
        ac = int((obs_alt & m).sum())
        dps = int((obs_cov & m).sum())
        if ac >= cfg.min_alternate_count and dps > 0 and (
            ac / dps >= cfg.min_alternate_fraction
        ):
            return True
    return False


def _build_simple_snv_locus(
    group: List[dict], ref_codes: np.ndarray, p: WindowPileup,
    cfg: CallerConfig,
) -> _Locus:
    """All atoms are SNVs at one offset → (multi-allelic) SNP locus."""
    off = group[0]["off"]
    col, q, _ = p.col(off)
    ref_code = int(ref_codes[off])
    order = sorted(group, key=lambda a: -a["count"])[: cfg.max_alts]
    alt_codes = [a["alt_code"] for a in order]
    obs = np.full(len(col), -1, np.int8)
    obs[col == ref_code] = 0
    for k, ac in enumerate(alt_codes, start=1):
        obs[col == ac] = k
    # bases that are neither ref nor a kept alt stay "covering but other":
    # they count against every genotype equally → mark non-covering
    return _Locus(
        offset=off,
        ref=_BASES[ref_code],
        alts=[_BASES[c] for c in alt_codes],
        obs=obs,
        quals=np.maximum(q.astype(np.float32), 1.0),
        anchor=off,
    )


def _build_indel_locus(
    atom: dict, p: WindowPileup, cfg: CallerConfig
) -> _Locus:
    off = atom["off"]
    col, q, _ = p.col(off)
    alt_reads = atom["alt_reads"]
    obs = np.full(len(col), -1, np.int8)
    obs[(col >= 0) & ~alt_reads] = 0
    obs[alt_reads] = 1
    quals = np.full(len(col), float(cfg.indel_q), np.float32)
    return _Locus(
        offset=off, ref=atom["ref"], alts=[atom["alt"]],
        obs=obs, quals=quals, anchor=off,
    )


_HAP_PAD = 16        # band slack each side of a read's expected placement
_MAX_HAPS = 7        # candidate haplotypes per group incl. REF


@dataclass
class _HapJob:
    """One haplotype group's scoring work (batched per window)."""

    group: List[dict]
    w0: int
    w1: int
    read_idx: np.ndarray          # (nr,) covering / supporting reads
    cands: List[str]              # candidate mid strings, [0] = ref hap
    shifts: np.ndarray            # (nh, nr) expected-offset shift per hap
    snp_offs: List[int]
    scores: Optional[np.ndarray] = None   # (nr, nh) filled by the scorer


def _hap_group_job(
    group: List[dict], ref_codes: np.ndarray, p: WindowPileup,
    cfg: CallerConfig,
) -> Optional[_HapJob]:
    """Enumerate candidate haplotypes for one atom group.

    Candidates come from observations (freebayes-style): the projected
    SNP-combination haplotypes reads actually carry, each indel atom's
    haplotype, and indel+SNP joint haplotypes for indel-carrying reads'
    SNP projections.  Scoring/voting is NOT projection-based — every
    covering read is aligned against every candidate with the banded SW
    kernel (align.sw), so reads with sequencing errors or nearby indels
    still vote for the haplotype they best match."""
    w0 = min(a["span"][0] for a in group)
    w1 = max(a["span"][1] for a in group)
    w1 = min(w1, w0 + 128, len(ref_codes))
    if (ref_codes[w0:w1] >= 4).any():
        return None
    ref_hap = "".join(_BASES[c] for c in ref_codes[w0:w1])
    R = len(p.rstart)

    snp_offs = sorted({a["off"] for a in group if a["kind"] == "snp"
                       and w0 <= a["off"] < w1})
    indel_atoms = [a for a in group if a["kind"] == "indel"]

    full_cover = p.covers(w0, w1)
    indel_support = np.zeros(R, bool)
    for a in indel_atoms:
        indel_support |= a["alt_reads"]
    read_mask = full_cover | indel_support
    read_idx = np.nonzero(read_mask)[0]
    if len(read_idx) == 0:
        return None

    def apply_edits(edits: List[Tuple[int, str, str]]) -> Optional[str]:
        """Apply (off, ref, alt) edits right-to-left; None on overlap."""
        h = ref_hap
        last = len(ref_hap) + w0
        for off, rf, al in sorted(edits, key=lambda e: -e[0]):
            if off + len(rf) > last or off < w0:
                return None
            h = h[: off - w0] + al + h[off - w0 + len(rf):]
            last = off
        return h

    # projected SNP combinations actually observed (candidate generation
    # only — votes come from the DP scores)
    proj_combo_counts: Dict[Tuple[int, ...], int] = {}
    if snp_offs:
        cols = {o: p.col(o) for o in snp_offs}
        proj_mat = np.stack([cols[o][0] for o in snp_offs], axis=1)
        for ri in read_idx:
            row = proj_mat[ri]
            if (row >= 0).all() and full_cover[ri]:
                key = tuple(int(x) for x in row)
                proj_combo_counts[key] = proj_combo_counts.get(key, 0) + 1

    ref_combo = tuple(int(ref_codes[o]) for o in snp_offs)
    cands: List[str] = [ref_hap]
    shift_atoms: List[List[Tuple[int, int]]] = [[]]   # (off, len_diff)

    def add_cand(h: Optional[str], atoms: List[Tuple[int, int]]):
        if h is not None and h not in cands and len(cands) < _MAX_HAPS:
            cands.append(h)
            shift_atoms.append(atoms)

    # SNP-combination haplotypes, most-observed first; singleton combos
    # (sequencing errors) are never candidates — error-carrying reads
    # instead DP-vote for the nearest real candidate
    for key, cnt in sorted(proj_combo_counts.items(), key=lambda kv: -kv[1]):
        if (key == ref_combo or any(c >= 4 for c in key)
                or cnt < cfg.min_alternate_count):
            continue
        edits = [
            (o, _BASES[int(ref_codes[o])], _BASES[c])
            for o, c in zip(snp_offs, key) if c != int(ref_codes[o])
        ]
        if edits:
            add_cand(apply_edits(edits), [])

    # indel haplotypes (and indel+SNP joints for the top SNP combo)
    top_combo = None
    for key, cnt in sorted(proj_combo_counts.items(), key=lambda kv: -kv[1]):
        if (key != ref_combo and not any(c >= 4 for c in key)
                and cnt >= cfg.min_alternate_count):
            top_combo = key
            break
    for a in sorted(indel_atoms, key=lambda x: -x["count"]):
        ed = (a["off"], a["ref"], a["alt"])
        add_cand(apply_edits([ed]), [(a["off"], len(a["alt"]) - len(a["ref"]))])
        if top_combo is not None:
            edits = [
                (o, _BASES[int(ref_codes[o])], _BASES[c])
                for o, c in zip(snp_offs, top_combo)
                if c != int(ref_codes[o])
            ]
            add_cand(apply_edits(edits + [ed]),
                     [(a["off"], len(a["alt"]) - len(a["ref"]))])

    if len(cands) == 1:
        return None

    # expected-offset shift of each read under each candidate: indels
    # left of the read's start move its haplotype-frame placement
    start_off = p.read_pos[read_idx].astype(np.int64) - p.start
    nh, nr = len(cands), len(read_idx)
    shifts = np.zeros((nh, nr), np.int64)
    for k, atoms in enumerate(shift_atoms):
        for off, dlen in atoms:
            shifts[k] += np.where(start_off > off, dlen, 0)
    return _HapJob(group=group, w0=w0, w1=w1, read_idx=read_idx,
                   cands=cands, shifts=shifts, snp_offs=snp_offs)


def _score_hap_jobs(
    jobs: List[_HapJob], p: WindowPileup, genome: np.ndarray,
    device: torch.device,
) -> None:
    """Score every (read, candidate-haplotype) lane of all jobs in ONE
    call of the unbanded score-only DP (align.sw.banded_sw_score — the
    haplotype evaluation of the reference contract, bin/speedseq:707) on
    ``device``.  Fills job.scores (nr, nh).  A failure of the device call
    raises DeviceError."""
    from ..align.sw import banded_sw_score
    from ..formats.fasta import encode_bases

    Lmax = p.read_seq.shape[1]
    PAD = _HAP_PAD
    W = Lmax + 2 * PAD
    W = ((W + 63) // 64) * 64
    lanes_q: List[np.ndarray] = []
    lanes_l: List[np.ndarray] = []
    lanes_r: List[np.ndarray] = []
    for job in jobs:
        nr = len(job.read_idx)
        flank = Lmax + PAD
        hs = p.start + job.w0
        left = genome[max(hs - flank, 0): hs]
        right = genome[p.start + job.w1: p.start + job.w1 + flank]
        ext_start = hs - len(left)
        rp = p.read_pos[job.read_idx].astype(np.int64)
        for k, mid in enumerate(job.cands):
            ext = np.concatenate(
                [left, encode_bases(mid.encode()), right]).astype(np.int64)
            off = rp - ext_start + job.shifts[k] - PAD        # (nr,)
            idx = off[:, None] + np.arange(W)[None, :]
            ok = (idx >= 0) & (idx < len(ext))
            win = np.where(ok, ext[np.clip(idx, 0, len(ext) - 1)], 4)
            lanes_r.append(win)
        lanes_q.append(np.repeat(
            p.read_seq[job.read_idx][None], len(job.cands), axis=0
        ).reshape(-1, Lmax))
        lanes_l.append(np.repeat(
            p.read_len[job.read_idx][None], len(job.cands), axis=0
        ).reshape(-1))
    q = np.concatenate(lanes_q).astype(np.int32)
    ql = np.concatenate(lanes_l).astype(np.int32)
    rw = np.concatenate(lanes_r).astype(np.int32)
    try:
        with metrics.timer("var.hap_scan"):
            sc = banded_sw_score(
                *(torch.from_numpy(a).to(device) for a in (q, ql, rw))
            ).score.cpu().numpy()
    except Exception as e:
        raise DeviceError(
            f"haplotype scan of {len(q)} lanes on {device} failed: "
            f"{type(e).__name__}: {e}") from e
    metrics.add(f"var.hap_scan_calls.{device.type}")
    metrics.add(f"var.hap_scan_lanes.{device.type}", len(q))
    at = 0
    for job in jobs:
        nh, nr = len(job.cands), len(job.read_idx)
        # lanes are hap-major within a job
        job.scores = sc[at: at + nh * nr].reshape(nh, nr).T   # (nr, nh)
        at += nh * nr


def _finish_hap_locus(
    job: _HapJob, ref_codes: np.ndarray, p: WindowPileup,
    n_samples: int, cfg: CallerConfig, sample_of_read: np.ndarray,
) -> Optional[List[_Locus]]:
    """Turn DP scores into votes, apply per-sample -C/-F admission, and
    build the (multi-allelic) haplotype locus."""
    R = len(p.rstart)
    sc = job.scores                                  # (nr, nh)
    nr, nh = sc.shape
    ref_hap = job.cands[0]
    best = np.argmax(sc, axis=1)
    srt = np.sort(sc, axis=1)
    margin = (srt[:, -1] - srt[:, -2]).astype(np.float64)
    vote = np.where(margin >= 1, best, -1)           # ties are ambiguous
    # observation quality: freebayes-style haplotype observation quality
    # — the minimum base quality across the locus's discriminating SNP
    # columns the read covers [external knowledge: freebayes assigns a
    # haplotype observation the min base quality of its allele window].
    # This makes haplotype-locus GLs reduce to the SAME closed-form
    # diploid model as the biallelic SNV fixture (anchored by the MNP
    # and indel+SNP fixtures in tests/test_var.py).  Reads that
    # discriminate only through alignment structure (pure-indel groups,
    # or no SNP-column coverage) fall back to the score-margin estimate:
    # one discriminating base ≈ match+mismatch = 5 score units at ~Q30.
    margin_qual = np.clip(6.0 * margin, 3.0, 41.0)
    if job.snp_offs:
        qcols = np.stack([p.col(o)[1] for o in job.snp_offs], axis=1)
        qr = qcols[job.read_idx].astype(np.float64)      # (nr, K)
        qr = np.where(qr > 0, qr, 1e9)
        minq = qr.min(axis=1)
        hap_qual = np.where(
            minq < 1e9, np.clip(minq, 3.0, 41.0), margin_qual
        ).astype(np.float32)
    else:
        hap_qual = margin_qual.astype(np.float32)

    covering = vote >= 0
    passing: List[int] = []
    for k in range(1, nh):
        is_k = vote == k
        if not is_k.any():
            continue
        if int(is_k.sum()) < cfg.min_alternate_count:
            continue
        if _passes_per_sample(
            _expand(is_k, job.read_idx, R),
            _expand(covering, job.read_idx, R),
            sample_of_read, n_samples, cfg,
        ):
            passing.append(k)
    passing = sorted(
        passing, key=lambda k: -int((vote == k).sum()))[: cfg.max_alts]
    if not passing:
        return []

    obs = np.full(R, -1, np.int8)
    quals = np.full(R, 3.0, np.float32)
    quals[job.read_idx] = hap_qual
    obs_local = np.full(nr, -1, np.int8)
    obs_local[vote == 0] = 0
    for a_i, k in enumerate(passing, start=1):
        obs_local[vote == k] = a_i
    obs[job.read_idx] = obs_local
    off2, ref2, alts2 = _minimalize(
        job.w0, ref_hap, [job.cands[k] for k in passing])
    return [
        _Locus(
            offset=off2, ref=ref2, alts=alts2, obs=obs, quals=quals,
            anchor=job.snp_offs[0] if job.snp_offs else job.w0,
        )
    ]


def _expand(mask_local: np.ndarray, idx: np.ndarray, R: int) -> np.ndarray:
    out = np.zeros(R, bool)
    out[idx] = mask_local
    return out


def _build_loci(
    genome: np.ndarray, p: WindowPileup, n_samples: int, cfg: CallerConfig,
    sample_of_read: np.ndarray, device: torch.device,
) -> List[_Locus]:
    ref_codes = genome[p.start : p.end]
    with metrics.timer("var.loci.atoms"):
        atoms = _collect_atoms(genome, p, n_samples, cfg, sample_of_read)
    metrics.add("var.atoms", len(atoms))
    loci: List[_Locus] = []
    hap_groups: List[List[dict]] = []
    made = {"snv": 0, "indel": 0, "hap": 0}   # loci by kind
    for group in _group_atoms(atoms, cfg.haplotype_gap):
        snp_offs = {a["off"] for a in group if a["kind"] == "snp"}
        only_snps = all(a["kind"] == "snp" for a in group)
        if only_snps and len(snp_offs) == 1:
            loci.append(_build_simple_snv_locus(group, ref_codes, p, cfg))
            made["snv"] += 1
            continue
        if len(group) == 1 and group[0]["kind"] == "indel":
            loci.append(_build_indel_locus(group[0], p, cfg))
            made["indel"] += 1
            continue
        hap_groups.append(group)

    if hap_groups:
        with metrics.timer("var.loci.hap"):
            # two-pass: enumerate candidates per group, then ONE batched SW
            # kernel call over every (read, candidate) lane of the window
            jobs = []
            job_of_group: List[Optional[_HapJob]] = []
            for group in hap_groups:
                job = _hap_group_job(group, ref_codes, p, cfg)
                job_of_group.append(job)
                if job is not None:
                    jobs.append(job)
            metrics.add("var.hap_groups", len(hap_groups))
            metrics.add("var.hap_cands", sum(len(j.cands) for j in jobs))
            if jobs:
                _score_hap_jobs(jobs, p, genome, device)
            for group, job in zip(hap_groups, job_of_group):
                res = None
                if job is not None:
                    res = _finish_hap_locus(
                        job, ref_codes, p, n_samples, cfg, sample_of_read)
                if res:
                    loci.extend(res)
                    made["hap"] += len(res)
                    continue
                # fallback: evaluate atoms independently (no joint allele
                # supported by the DP votes)
                by_off: Dict[int, List[dict]] = {}
                for a in group:
                    if a["kind"] == "snp":
                        by_off.setdefault(a["off"], []).append(a)
                    else:
                        loci.append(_build_indel_locus(a, p, cfg))
                        made["indel"] += 1
                for off, snps in sorted(by_off.items()):
                    loci.append(_build_simple_snv_locus(snps, ref_codes, p,
                                                        cfg))
                    made["snv"] += 1
    for kind, k in made.items():
        metrics.add(f"var.loci.{kind}", k)
    loci.sort(key=lambda l: l.offset)
    return loci


# log10 prior by number of non-ref alleles in the genotype
def _log_priors(theta: float) -> np.ndarray:
    lp = np.zeros(_N_GT)
    lt = np.log10(theta)
    for g, (j, k) in enumerate(_GT_PAIRS):
        m = (j > 0) + (k > 0)
        lp[g] = m * lt
    return lp


@dataclass
class PreparedWindow:
    """Host-built loci + per-site compacted device inputs for one window
    (the unit the cross-window batched dispatch concatenates)."""

    loci: List[_Locus]
    obs: np.ndarray        # (S, Rc) int8 compacted
    quals: np.ndarray      # (S, Rc) f32
    sample: np.ndarray     # (S, Rc) int32
    rpos: np.ndarray       # (S, Rc) int32
    strand: np.ndarray     # (S, Rc) int8
    rlen_half: np.ndarray  # (S, Rc) f32
    n_alts: np.ndarray     # (S,) int32


def prepare_window(
    genome: np.ndarray,
    p: WindowPileup,
    n_samples: int,
    cfg: CallerConfig = CallerConfig(),
    device=None,
) -> Optional[PreparedWindow]:
    """Host phase of call_window: candidate loci (whose haplotype scan
    runs on ``device``) + compacted site arrays; no genotyping, so many
    windows can batch into ONE genotyping program."""
    R = len(p.rstart)
    if R == 0:
        return None
    sample_of_read = np.asarray(p.sample_of_read, np.int32)
    loci = _build_loci(genome, p, n_samples, cfg, sample_of_read,
                       resolve_device(device))
    if not loci:
        return None
    from .device import compact_site_reads

    with metrics.timer("var.loci.compact"):
        strand_of_read = np.asarray(p.strand, np.int8)
        rlen_half = np.where(p.read_len > 0, p.read_len / 2.0, 50.0)
        obs = np.stack([l.obs for l in loci])                  # (S, R)
        quals = np.stack([l.quals for l in loci]).astype(np.float32)
        n_alts = np.array([len(l.alts) for l in loci], np.int32)
        rpos = np.stack([p.col(l.anchor)[2] for l in loci])    # (S, R)
        c_obs, c_quals, c_sam, c_rpos, c_str, c_rl = compact_site_reads(
            obs, quals, sample_of_read, rpos, strand_of_read,
            rlen_half.astype(np.float32))
    return PreparedWindow(
        loci=loci, obs=c_obs, quals=c_quals, sample=c_sam, rpos=c_rpos,
        strand=c_str, rlen_half=c_rl, n_alts=n_alts)


def finish_window(
    pw: PreparedWindow, g, cfg: CallerConfig,
) -> List[SiteCall]:
    """Emit SiteCalls from a window's device results (g may be a slice
    of a batched multi-window program's outputs)."""
    loci = pw.loci
    obs = pw.obs
    joint = g.joint
    out: List[SiteCall] = []
    for s, l in enumerate(loci):
        A = len(l.alts)
        alt_any = (obs[s] >= 1) & (obs[s] <= A)
        if not alt_any.any():
            continue
        if joint is not None:
            best_pairs = np.array([
                _GT_PAIRS[int(joint.gn[s])], _GT_PAIRS[int(joint.gt[s])]])
        else:
            best_pairs = np.array([_GT_PAIRS[int(gi)] for gi in g.gt_idx[s]])
        if not cfg.pooled_discrete and not (best_pairs > 0).any():
            # freebayes emits only polymorphic loci; pooled-discrete mode
            # keeps hom-ref records so the SSC filter sees marginal GLs
            continue
        # valid-genotype GL slice for this locus's ploidy
        keep_g = [gi for gi, (j, k) in enumerate(_GT_PAIRS) if k <= A]
        types, lens = zip(*[_allele_type(l.ref, a) for a in l.alts])
        out.append(
            SiteCall(
                offset=l.offset, ref=l.ref, alts=list(l.alts),
                types=list(types), lengths=list(lens),
                gt=best_pairs,
                gq=(joint.gq[s] if joint is not None else g.gq[s]),
                gl=g.gl[s][:, keep_g].astype(np.float64),
                dp=g.dp[s], ro=g.ro[s], ao=g.ao[s, :, :A],
                qr=g.qr[s], qa=g.qa[s, :, :A],
                qual=float(max(0.0, (joint.qual[s] if joint is not None
                                     else g.qual[s]))),
                rpl=g.rpl[s, :A], rpr=g.rpr[s, :A],
                saf=g.saf[s, :A], sar=g.sar[s, :A],
            )
        )
    return out


def call_window(
    genome: np.ndarray,
    p: WindowPileup,
    n_samples: int,
    cfg: CallerConfig = CallerConfig(),
    device=None,
    mesh=None,
) -> List[SiteCall]:
    """Genotype all candidate loci of one window pileup (single-window
    convenience: prepare → one genotyping program → emit), on ``device``
    (cuda unless the caller asks for cpu); ``mesh`` shards the
    genotyping program's site axis (var.device.genotype_sites).

    The numeric core (GL terms, per-sample reductions, GQ, posterior
    QUAL, placement/strand balance, pooled-discrete joint) runs as one
    device program (var.device.genotype_sites); the host builds loci and
    emits records.  The var engine batches MANY windows into one program
    instead (genotype_windows)."""
    device = resolve_device(device)
    pw = prepare_window(genome, p, n_samples, cfg, device)
    if pw is None:
        return []
    from .device import genotype_sites

    g = genotype_sites(
        pw.obs, pw.quals, pw.sample, pw.rpos, pw.strand, pw.rlen_half,
        pw.n_alts, cfg.theta, n_samples, device=device,
        pooled=cfg.pooled_discrete and n_samples == 2, mesh=mesh,
    )
    return finish_window(pw, g, cfg)


def genotype_windows(
    prepared: List[Optional[PreparedWindow]],
    n_samples: int,
    cfg: CallerConfig,
    device=None,
    mesh=None,
) -> List[Optional["object"]]:
    """Run ONE genotyping program per compacted read width over every
    prepared window's sites (site axes concatenated; sharded over
    ``mesh`` when given) and slice the results back per window."""
    from .device import genotype_sites, slice_genotypes

    live = [(i, pw) for i, pw in enumerate(prepared) if pw is not None]
    out: List[Optional[object]] = [None] * len(prepared)
    if not live:
        return out
    # group by the compacted read width Rc (already 128-bucketed per
    # window): padding every window to the WIDEST window's coverage
    # would re-introduce the dense-axis waste the per-site compaction
    # removed; distinct Rc values are few
    by_rc: Dict[int, List[Tuple[int, PreparedWindow]]] = {}
    for i, pw in live:
        by_rc.setdefault(pw.obs.shape[1], []).append((i, pw))
    pooled = cfg.pooled_discrete and n_samples == 2
    for rc, group in sorted(by_rc.items()):
        obs = np.concatenate([pw.obs for _, pw in group])
        quals = np.concatenate([pw.quals for _, pw in group])
        sample = np.concatenate([pw.sample for _, pw in group])
        rpos = np.concatenate([pw.rpos for _, pw in group])
        strand = np.concatenate([pw.strand for _, pw in group])
        rlen_half = np.concatenate([pw.rlen_half for _, pw in group])
        n_alts = np.concatenate([pw.n_alts for _, pw in group])
        g_all = genotype_sites(
            obs, quals, sample, rpos, strand, rlen_half, n_alts,
            cfg.theta, n_samples, device=device, pooled=pooled, mesh=mesh,
        )
        at = 0
        for i, pw in group:
            S = len(pw.loci)
            out[i] = slice_genotypes(g_all, at, at + S)
            at += S
    return out


def site_to_vcf(
    call: SiteCall, chrom: str, window_start: int, n_samples: int
) -> VCFRecord:
    A = len(call.alts)
    total_dp = int(call.dp.sum())
    total_ro = int(call.ro.sum())
    total_ao = call.ao.sum(axis=0)                         # (A,)
    ab = [
        round(int(a) / max(1, total_ro + int(a)), 6) for a in total_ao
    ]

    def lst(x):
        vals = [int(v) if float(v).is_integer() else float(v) for v in x]
        return vals[0] if A == 1 else vals

    info = {
        "DP": total_dp,
        "RO": total_ro,
        "AO": lst(total_ao),
        "AB": ab[0] if A == 1 else ab,
        "RPL": lst(call.rpl),
        "RPR": lst(call.rpr),
        "SAF": lst(call.saf),
        "SAR": lst(call.sar),
        "TYPE": call.types[0] if A == 1 else call.types,
        "LEN": lst(call.lengths),
        "NUMALT": A,
    }
    samples = []
    for si in range(n_samples):
        j, k = int(call.gt[si][0]), int(call.gt[si][1])
        samples.append(
            {
                "GT": f"{j}/{k}",
                "GQ": int(call.gq[si]),
                "DP": int(call.dp[si]),
                "RO": int(call.ro[si]),
                "QR": int(call.qr[si]),
                "AO": lst(call.ao[si]),
                "QA": lst(call.qa[si]),
                "GL": [round(float(x), 2) for x in call.gl[si]],
            }
        )
    return VCFRecord(
        chrom=chrom,
        pos=window_start + call.offset,
        id=".",
        ref=call.ref,
        alt=list(call.alts),
        qual=round(call.qual, 2),
        filter=".",
        info=info,
        format=["GT", "GQ", "DP", "RO", "QR", "AO", "QA", "GL"],
        samples=samples,
    )
