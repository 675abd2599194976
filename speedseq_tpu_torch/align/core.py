"""Alignment orchestration on the device: seeds → chains → pair selection →
SW extension (+ mate rescue, extra XA placements) → packed outputs.

Counterpart of speedseq_tpu/align/core.py.  Plain functions on tensors;
every tensor of a call lies on one device.  Phase 1
(``weight_candidates``) seeds either from the hash k-mer index (``kidx``
given, the default path: seeding and chaining of both ends in one launch
of ops/seed_chain.py's kernel) or by SMEM search on the FMD index
(``kidx=None``, ``seed_mode="fm"``: the ``fm_smem`` and ``fm_sa_walk``
kernels of ops/fm_search.py); the two banded Smith-Waterman kernels
(ops/sw_banded.py) do the DP.  The host side (numpy
unpacking, MAPQ) is unchanged.

The unfused alignment API is here too: ``align_candidates`` (SMEM seeds,
the sorting chainer and the unbanded traceback DP ``sw.banded_sw`` over
every chain, on the tensors' device) and its host selection
(``choose_candidates``, ``select_alignments``, ``finalize_alignments``:
the JAX package's numpy code, each fetching its tensors once).

The fused step runs in five stages, each a span ``align.stage.<s>``
(``utils/metrics.py``): ``seed_chain``, ``select``, ``extend``,
``rescue_xa`` and ``pack``.  Inside ``stage_marks`` on cuda each stage
also records a CUDA event where it ends, so its stream span can be read
once the step has run.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..index.fm import FMIndex, get_ref_window_packed
from ..index.kmer import KmerIndex
from ..utils.metrics import metrics
from ..ops.seed_chain import seed_chain
from .chain import chain_seeds
from .seeding import find_seeds
from .sw import SWParams, banded_sw, banded_sw_pallas, banded_sw_score_pallas

PAD = 44  # ref-window slack each side of the chain anchor diagonal
# windows start 16-aligned (word-gather path) so W carries +16 alignment
# slack; W = L + 2*PAD + 16 ≤ 256 up to L=151, padded to 256 for the kernels

i32 = torch.int32


class Candidates(NamedTuple):
    """Extended alignment candidates per read; (B, S, ...) tensors."""

    pos: torch.Tensor       # (B, S) int32 leftmost genome pos (fwd strand)
    strand: torch.Tensor    # (B, S) int32
    score: torch.Tensor     # (B, S) int32 SW score (0 = no alignment)
    qbeg: torch.Tensor      # (B, S) strand-frame query start
    qend: torch.Tensor      # (B, S)
    rend_pos: torch.Tensor  # (B, S) genome end pos (exclusive)
    cigar_ops: torch.Tensor  # (B, S, MAX_OPS) int32 (align_candidates: int8)
    cigar_len: torch.Tensor  # (B, S, MAX_OPS) int32
    n_ops: torch.Tensor     # (B, S)
    seed_cov: torch.Tensor  # (B, S) chain weight (seed coverage)
    refwin: torch.Tensor    # (B, S, W) uint8 ref window
    rstart: torch.Tensor    # (B, S) int32 window genome start
    nm: torch.Tensor        # (B, S) int32 edit distance from the kernel
    # (-1 = unknown: the host derives NM/MD from refwin)


class ScoredChains(NamedTuple):
    """Phase-1 output: chain candidates with scores; all (B, K)."""

    pos: torch.Tensor
    rend_pos: torch.Tensor
    strand: torch.Tensor
    score: torch.Tensor
    anchor_rpos: torch.Tensor
    anchor_qpos: torch.Tensor
    qspan_beg: torch.Tensor
    qspan_end: torch.Tensor
    qend: torch.Tensor
    valid: torch.Tensor


def revcomp_reads(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement honoring per-read length; padding 4."""
    B, L = reads.shape
    idx = lengths.to(i32)[:, None] - 1 - torch.arange(
        L, dtype=i32, device=reads.device)[None, :]
    vals = torch.gather(reads.to(i32), 1, idx.clamp(0, L - 1).long())
    comp = torch.where(vals < 4, 3 - vals, vals)
    return torch.where(idx >= 0, comp, 4).to(i32)


def _strand_queries(reads, lengths, strand):
    """(B*S, L) queries: the read or its reverse complement per slot."""
    B, L = reads.shape
    S = strand.shape[1]
    rc = revcomp_reads(reads, lengths)
    q = torch.where(strand[..., None] == 1, rc[:, None, :], reads[:, None, :])
    return q.reshape(B * S, L)


def _windows(fm: FMIndex, rstart: torch.Tensor, W: int) -> tuple:
    """(uint8 (N, W) windows, int32 (N, 256) kernel input padded with 4)."""
    refwin = get_ref_window_packed(fm, rstart.reshape(-1), W)
    Wp = ((W + 127) // 128) * 128
    refp = Fn.pad(refwin.to(i32), (0, Wp - W), value=4)
    return refwin, refp


def _window_start(anchor_rpos, anchor_qpos):
    return ((anchor_rpos - anchor_qpos - PAD) >> 4) << 4


def align_candidates(fm: FMIndex, reads, lengths, n_chains: int = 4,
                     stride: int = 8, min_seed_len: int = 19,
                     max_hits: int = 4, params: SWParams = SWParams()
                     ) -> Candidates:
    """The unfused forward step: SMEM seeds (``fm`` needs its FMD arrays)
    → the sorting chainer → the unbanded traceback DP (``sw.banded_sw``,
    one launch of ``ssq_sw_unbanded_cigar`` on cuda) of every chain's
    strand query against its 16-aligned window of W = L + 2 PAD + 16 bases
    (L <= 152, so W <= 256).  Returns (B, K) Candidates with nm = -1: the
    host derives NM/MD from ``refwin``."""
    B, L = reads.shape
    reads = reads.to(i32)
    seeds = find_seeds(fm, reads, lengths, stride=stride,
                       min_seed_len=min_seed_len, max_hits=max_hits)
    chains = chain_seeds(seeds, L, k=n_chains)
    K = n_chains
    W = L + 2 * PAD + 16
    strand = chains.strand
    queries = _strand_queries(reads, lengths, strand)
    rstart = _window_start(chains.anchor_rpos, chains.anchor_qpos)
    refwin = get_ref_window_packed(fm, rstart.reshape(-1), W)
    qlen = lengths.to(i32)[:, None].expand(B, K).reshape(-1)
    sw = banded_sw(queries, qlen, refwin.to(i32), params=params)
    score = torch.where(chains.valid.reshape(-1), sw.score, 0).reshape(B, K)
    return Candidates(
        pos=(rstart.reshape(-1) + sw.rbeg).reshape(B, K),
        strand=strand,
        score=score,
        qbeg=sw.qbeg.reshape(B, K),
        qend=sw.qend.reshape(B, K),
        rend_pos=(rstart.reshape(-1) + sw.rend).reshape(B, K),
        cigar_ops=sw.cigar_ops.reshape(B, K, -1),
        cigar_len=sw.cigar_len.reshape(B, K, -1),
        n_ops=sw.n_ops.reshape(B, K),
        seed_cov=chains.weight,
        refwin=refwin.reshape(B, K, W),
        rstart=rstart,
        nm=torch.full((B, K), -1, dtype=i32, device=reads.device),
    )


def weight_candidates(fm: FMIndex, ends, kidx: KmerIndex = None,
                      n_chains: int = 4, stride: int = 8,
                      min_seed_len: int = 19, max_hits: int = 4) -> list:
    """Phase 1 of each (reads, lengths) end of ``ends``, without any DP:
    chain weight (exact-match query coverage) is the selection score; the
    selected slots get real scores and cigars from the single extension
    pass.  With ``kidx``, one seed_chain call for all ends (one launch on
    cuda), whose chains' weight is already 0 where a chain is not valid;
    else, an end at a time, SMEM seeds on the FMD index and the sorting
    chainer.  Returns one ScoredChains an end."""
    if kidx is not None:
        return [_weighted(ch, pos, rend, ch.weight) for ch, pos, rend in
                seed_chain(kidx, ends, k=min_seed_len, stride=stride,
                           max_hits=max_hits, n_chains=n_chains)]
    out = []
    for reads, lengths in ends:
        reads = reads.to(i32)
        seeds = find_seeds(fm, reads, lengths, stride=stride,
                           min_seed_len=min_seed_len, max_hits=max_hits)
        chains = chain_seeds(seeds, reads.shape[1], k=n_chains)
        diag = chains.anchor_rpos - chains.anchor_qpos
        out.append(_weighted(chains, diag + chains.qspan_beg,
                             diag + chains.qspan_end,
                             torch.where(chains.valid, chains.weight, 0)))
    return out


def _weighted(chains, pos, rend_pos, score) -> ScoredChains:
    return ScoredChains(
        pos=pos,
        rend_pos=rend_pos,
        strand=chains.strand,
        score=score,
        anchor_rpos=chains.anchor_rpos,
        anchor_qpos=chains.anchor_qpos,
        qspan_beg=chains.qspan_beg,
        qspan_end=chains.qspan_end,
        qend=chains.qspan_end,
        valid=chains.valid,
    )


def device_estimate_distro(stats, fallback: torch.Tensor,
                           qlen: int) -> torch.Tensor:
    """Insert-distro estimation on the device (best FR placements, two-round
    4σ trim).  ``stats`` is (2, 4, B, K) [pos, strand, score, rend] per end;
    returns (4,) float32 [mean, std, low, high], or ``fallback`` when fewer
    than 8 usable pairs exist."""
    (pos1, str1, sc1, end1), (pos2, str2, sc2, end2) = stats
    b = torch.arange(pos1.shape[0], device=pos1.device)
    k1 = torch.argmax(sc1, dim=1)
    k2 = torch.argmax(sc2, dim=1)
    p1, t1, s1, e1 = pos1[b, k1], str1[b, k1], sc1[b, k1], end1[b, k1]
    p2, t2, s2, e2 = pos2[b, k2], str2[b, k2], sc2[b, k2], end2[b, k2]
    good = (s1 > qlen // 2) & (s2 > qlen // 2) & (t1 != t2)
    left = torch.minimum(p1, p2)
    right = torch.maximum(e1, e2)
    isize = (right - left).to(torch.float32)
    fwd_first = torch.where(p1 <= p2, t1 == 0, t2 == 0)
    good = good & fwd_first & (isize > 0) & (isize < 10000)

    def ms(mask):
        cnt = mask.sum()
        cf = torch.clamp_min(cnt, 1).to(torch.float32)
        mf = mask.to(torch.float32)
        m = (isize * mf).sum() / cf
        v = (((isize - m) ** 2) * mf).sum() / cf
        return m, torch.clamp_min(torch.sqrt(v), 1.0), cnt

    m0, sd0, c0 = ms(good)
    mask1 = good & ((isize - m0).abs() <= 4 * sd0)
    m1, sd1, _ = ms(mask1)
    mask2 = mask1 & ((isize - m1).abs() <= 4 * sd1)
    m2, sd2, _ = ms(mask2)
    est = torch.stack([
        m2, sd2,
        torch.clamp_min(torch.trunc(m2 - 4 * sd2), 0.0),
        torch.trunc(m2 + 4 * sd2),
    ])
    return torch.where(c0 >= 8, est, fallback.to(est.device))


def extend_candidates(fm: FMIndex, reads, lengths, anchor_rpos, anchor_qpos,
                      strand, params: SWParams = SWParams()) -> Candidates:
    """Phase 2: banded SW + traceback (the cigar kernel) for the selected
    chains only; anchor_rpos < 0 marks an empty slot."""
    B, L = reads.shape
    S = anchor_rpos.shape[1]
    reads = reads.to(i32)
    W = L + 2 * PAD + 16
    queries = _strand_queries(reads, lengths, strand)
    rstart = _window_start(anchor_rpos, anchor_qpos)
    refwin, refp = _windows(fm, rstart, W)
    qlen = lengths.to(i32)[:, None].expand(B, S).reshape(-1)
    sw, nm = banded_sw_pallas(queries, qlen, refp, params=params,
                              with_nm=True)
    valid = (anchor_rpos >= 0).reshape(-1)
    return Candidates(
        pos=(rstart.reshape(-1) + sw.rbeg).reshape(B, S),
        strand=strand,
        score=torch.where(valid, sw.score, 0).reshape(B, S),
        qbeg=sw.qbeg.reshape(B, S),
        qend=sw.qend.reshape(B, S),
        rend_pos=(rstart.reshape(-1) + sw.rend).reshape(B, S),
        cigar_ops=sw.cigar_ops.reshape(B, S, -1),
        cigar_len=sw.cigar_len.reshape(B, S, -1),
        n_ops=sw.n_ops.reshape(B, S),
        seed_cov=torch.zeros((B, S), dtype=i32, device=reads.device),
        refwin=refwin.reshape(B, S, W),
        rstart=rstart,
        nm=nm.reshape(B, S),
    )


def _device_choose(sc: ScoredChains, lengths, chosen_k: Optional[torch.Tensor],
                   min_out_score: int = 30, mask_level: float = 0.5,
                   match: int = 1):
    """Device-side candidate selection: primary slot, split/secondary slot,
    MAPQ sub-score stats and the extra-XA chain mask."""
    score, pos, rend = sc.score, sc.pos, sc.rend_pos
    B, K = score.shape
    dev = score.device
    bidx = torch.arange(B, device=dev)
    kp = chosen_k if chosen_k is not None else torch.argmax(score, dim=1)
    sp = score[bidx, kp]
    posp = pos[bidx, kp][:, None]
    rendp = rend[bidx, kp][:, None]
    ovl = ~((rend <= posp) | (pos >= rendp))
    kk = torch.arange(K, device=dev)[None, :]
    other = kk != kp[:, None]
    live = other & (score > 0)
    non_ovl = live & ~ovl
    sub = torch.where(non_ovl, score, 0).amax(1)
    sub_n = (non_ovl & (score >= (sp - 3 * match)[:, None])).sum(1).to(i32)
    qlen = lengths.to(i32)[:, None]
    ob = torch.where(sc.strand == 1, qlen - sc.qspan_end, sc.qspan_beg)
    oe = torch.where(sc.strand == 1, qlen - sc.qspan_beg, sc.qspan_end)
    pb = ob[bidx, kp][:, None]
    pe = oe[bidx, kp][:, None]
    qov = torch.clamp_min(torch.minimum(pe, oe) - torch.maximum(pb, ob), 0)
    shorter = torch.clamp_min(torch.minimum(pe - pb, oe - ob), 1)
    split_ok = non_ovl & (score >= min_out_score) & (qov < mask_level * shorter)
    supp_score = torch.where(split_ok, score, -1)
    sec_score = torch.where(non_ovl & ~split_ok, score, -1)
    ks_split = torch.argmax(supp_score, dim=1)
    ks_sec = torch.argmax(sec_score, dim=1)
    has_split = supp_score[bidx, ks_split] > 0
    has_sec = sec_score[bidx, ks_sec] > 0
    ks = torch.where(has_split, ks_split, ks_sec)
    has_supp = has_split | has_sec
    a_rpos = torch.stack(
        [sc.anchor_rpos[bidx, kp],
         torch.where(has_supp, sc.anchor_rpos[bidx, ks], -1)], dim=1)
    a_qpos = torch.stack(
        [sc.anchor_qpos[bidx, kp],
         torch.where(has_supp, sc.anchor_qpos[bidx, ks], 0)], dim=1)
    a_strand = torch.stack(
        [sc.strand[bidx, kp],
         torch.where(has_supp, sc.strand[bidx, ks], 0)], dim=1)
    # extra XA candidates: non-overlapping placements within 80% of the
    # primary score (5·s ≥ 4·sp), excluding the chosen and slot-1 chains
    is_slot1 = has_supp[:, None] & (kk == ks[:, None])
    xa_mask = (non_ovl & (score >= min_out_score)
               & (5 * score >= 4 * sp[:, None]) & ~is_slot1)
    return (a_rpos.to(i32), a_qpos.to(i32), a_strand.to(i32), sub.to(i32),
            sub_n, xa_mask)


def _device_pair_select(sc1: ScoredChains, sc2: ScoredChains,
                        distro: torch.Tensor, pen_unpaired: int = 17):
    """Joint pair selection; distro (4,) float32 [mean, std, low, high].
    The pair penalty is integer (⌊0.72 z²⌋ as a floor division), so it is
    bit-stable across compilers and devices."""
    mean_i = torch.round(distro[0]).to(i32)
    std_i = torch.clamp(torch.round(distro[1]), 1, 4000).to(i32)
    high_i = torch.round(distro[3]).to(i32)
    pos1, pos2 = sc1.pos[:, :, None], sc2.pos[:, None, :]
    end1, end2 = sc1.rend_pos[:, :, None], sc2.rend_pos[:, None, :]
    st1, st2 = sc1.strand[:, :, None], sc2.strand[:, None, :]
    s1, s2 = sc1.score[:, :, None], sc2.score[:, None, :]
    left = torch.minimum(pos1, pos2)
    right = torch.maximum(end1, end2)
    isize = (right - left).to(i32)
    fwd_first = torch.where(pos1 <= pos2, st1 == 0, st2 == 0)
    proper = ((st1 != st2) & fwd_first & (isize > 0)
              & (isize <= high_i + 4 * std_i) & (s1 > 0) & (s2 > 0))
    d = torch.clamp(isize - mean_i, -5000, 5000)
    z2_pen = torch.div(72 * d * d, 100 * std_i * std_i, rounding_mode="floor")
    pen = torch.where(proper, torch.clamp_max(z2_pen, pen_unpaired + 8),
                      pen_unpaired)
    total = torch.where((s1 > 0) & (s2 > 0), s1 + s2 - pen,
                        torch.maximum(s1, s2) - pen_unpaired)
    B, K, _ = total.shape
    best = torch.argmax(total.reshape(B, K * K), dim=1)
    return (best // K), (best % K)


def _scatter_live(dst: torch.Tensor, rows: torch.Tensor, accept: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst[rows[accept], 0] = src[accept] without a host sync: rejected
    lanes write a dump row that is dropped.  Only live lanes land, so a
    read in row 0 is rescued like any other (dead lanes never touch it)."""
    B = dst.shape[0]
    tgt = torch.where(accept, rows, B)
    out = torch.cat([dst, dst[:1]], 0)
    out[tgt, 0] = src.to(dst.dtype)
    return out[:B]


def _first_live(mask: torch.Tensor, n: int):
    """(idx, live): the indices of the first ``n`` set entries of the 1-D
    ``mask`` (n,) int64, and which of the n slots hold one; a cumsum
    scatter without a host sync (slot n is the dump slot, and an empty
    slot's index is 0)."""
    dev = mask.device
    csum = torch.cumsum(mask.to(i32), 0) - 1
    slot = torch.where(mask & (csum < n), csum, n).long()
    idx = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    idx[slot] = torch.arange(mask.shape[0], device=dev)
    return idx[:n], torch.arange(n, device=dev) < mask.sum()


def _mate_rescue(fm: FMIndex, cand: Candidates, sc_self: ScoredChains,
                 sc_other: ScoredChains, k_other, reads, lengths,
                 distro: torch.Tensor, params: SWParams,
                 min_out_score: int = 30) -> Candidates:
    """bwa mem_matesw equivalent: an end with no seed chains whose mate
    aligned is searched inside the mate's insert window (FR orientation):
    up to R = B//32 such reads, 3 window tiles each scored by the score
    kernel, the best tile extended by the cigar kernel, accepted hits
    written into slot 0."""
    B, L = reads.shape
    dev = reads.device
    R = max(8, B // 32)
    bidx = torch.arange(B, device=dev)
    fail = sc_self.score.amax(1) <= 0
    mate_pos = sc_other.pos[bidx, k_other]
    mate_rend = sc_other.rend_pos[bidx, k_other]
    mate_strand = sc_other.strand[bidx, k_other]
    mate_ok = sc_other.score[bidx, k_other] > 0
    idxs, live = _first_live(fail & mate_ok, R)
    qlen_r = lengths.to(i32)[idxs]
    low, high = distro[2].to(i32), distro[3].to(i32)
    mp, mr, ms = mate_pos[idxs], mate_rend[idxs], mate_strand[idxs]
    lo_b = torch.where(ms == 0, mp + low - qlen_r, mr - high)
    hi_b = torch.where(ms == 0, mp + high - qlen_r, mr - low)
    lo_b = torch.clamp_min(lo_b, 0)
    hi_b = torch.maximum(hi_b, lo_b)
    t = (hi_b - lo_b).to(torch.float32)
    anchors = torch.stack(
        [lo_b + (t * f).to(i32) for f in (0.17, 0.5, 0.83)], dim=1).to(i32)
    strand_r = (1 - ms)[:, None].expand(R, 3).to(i32)
    reads_r = reads.to(i32)[idxs]
    # pass 1: score-only over the 3 window tiles
    W = L + 2 * PAD + 16
    q3 = _strand_queries(reads_r, qlen_r, strand_r)
    rst3 = ((anchors - PAD) >> 4) << 4
    _, ref3p = _windows(fm, rst3, W)
    ql3 = qlen_r[:, None].expand(R, 3).reshape(-1)
    s3 = banded_sw_score_pallas(q3, ql3, ref3p, params=params)
    jbest = torch.argmax(s3.score.reshape(R, 3), dim=1)
    ridx = torch.arange(R, device=dev)
    # pass 2: full traceback extension on the winning tile only
    resc = extend_candidates(
        fm, reads_r, qlen_r, anchors[ridx, jbest][:, None],
        torch.zeros((R, 1), dtype=i32, device=dev), strand_r[:, :1],
        params=params)
    rs = resc.score[:, 0]
    accept = live & (rs >= min_out_score)
    put = lambda dst, src: _scatter_live(dst, idxs, accept, src)
    return cand._replace(
        pos=put(cand.pos, resc.pos[:, 0]),
        strand=put(cand.strand, resc.strand[:, 0]),
        score=put(cand.score, rs),
        qbeg=put(cand.qbeg, resc.qbeg[:, 0]),
        qend=put(cand.qend, resc.qend[:, 0]),
        rend_pos=put(cand.rend_pos, resc.rend_pos[:, 0]),
        n_ops=put(cand.n_ops, resc.n_ops[:, 0]),
        rstart=put(cand.rstart, resc.rstart[:, 0]),
        nm=put(cand.nm, resc.nm[:, 0]),
        cigar_ops=put(cand.cigar_ops, resc.cigar_ops[:, 0]),
        cigar_len=put(cand.cigar_len, resc.cigar_len[:, 0]),
    )


class XACompact(NamedTuple):
    """Compacted extra-XA extension results (C lanes for the batch)."""

    read_idx: torch.Tensor   # (C,) int32 row in the batch; -1 = dead lane
    pos: torch.Tensor
    strand: torch.Tensor
    score: torch.Tensor
    qbeg: torch.Tensor
    qend: torch.Tensor
    rend_pos: torch.Tensor
    nm: torch.Tensor
    n_ops: torch.Tensor
    cigar_ops: torch.Tensor  # (C, MAX_OPS)
    cigar_len: torch.Tensor


def _extend_xa(fm: FMIndex, sc: ScoredChains, xa_mask, reads, lengths,
               params: SWParams) -> XACompact:
    """Compacted extension of extra XA chains into C = B//8 lanes (first-fit,
    overflow chains dropped)."""
    B, K = xa_mask.shape
    C = max(8, B // 8)
    src, live = _first_live(xa_mask.reshape(-1), C)
    rd, ch = src // K, src % K
    resc = extend_candidates(
        fm, reads[rd], lengths[rd], sc.anchor_rpos[rd, ch][:, None],
        sc.anchor_qpos[rd, ch][:, None], sc.strand[rd, ch][:, None],
        params=params)
    score = resc.score[:, 0]
    live = live & (score >= 30)
    return XACompact(
        read_idx=torch.where(live, rd, -1).to(i32),
        pos=resc.pos[:, 0], strand=resc.strand[:, 0], score=score,
        qbeg=resc.qbeg[:, 0], qend=resc.qend[:, 0],
        rend_pos=resc.rend_pos[:, 0], nm=resc.nm[:, 0],
        n_ops=resc.n_ops[:, 0],
        cigar_ops=resc.cigar_ops[:, 0], cigar_len=resc.cigar_len[:, 0],
    )


DEFAULT_DISTRO = (300.0, 100.0, 50.0, 700.0)


class StageMarks:
    """CUDA events at the stage boundaries of one device step: one where
    the first stage begins, then one where each stage segment ends.
    Consecutive segments of one stage share their end event (it is
    recorded again), so the marks tile the step."""

    def __init__(self, take: Callable[[], "torch.cuda.Event"]):
        self._take = take
        self.events: list = []
        self.stages: list = []

    def begin(self) -> None:
        if not self.events:
            self.events.append(self._take())
            self.events[0].record()

    def end(self, stage: str) -> None:
        if self.stages and self.stages[-1] == stage:
            self.events[-1].record()
            return
        ev = self._take()
        ev.record()
        self.events.append(ev)
        self.stages.append(stage)

    def seconds(self) -> Dict[str, float]:
        """Each stage's stream seconds; every event must have completed."""
        out: Dict[str, float] = {}
        for st, a, b in zip(self.stages, self.events, self.events[1:]):
            out[st] = out.get(st, 0.0) + a.elapsed_time(b) / 1e3
        return out


_marks = threading.local()


@contextmanager
def stage_marks(take: Optional[Callable[[], "torch.cuda.Event"]]):
    """Within, on the calling thread, the fused step's stages record
    their boundaries as CUDA events from ``take()`` (timing events, on
    the current stream); yields the StageMarks, or None when ``take`` is
    None."""
    if take is None:
        yield None
        return
    m = StageMarks(take)
    _marks.current = m
    try:
        yield m
    finally:
        _marks.current = None


@contextmanager
def _stage(name: str):
    """Span ``align.stage.<name>``, and its stream marks inside
    stage_marks."""
    m = getattr(_marks, "current", None)
    with metrics.timer("align.stage." + name):
        if m is not None:
            m.begin()
        yield
        if m is not None:
            m.end(name)


def fused_align_step(fm: FMIndex, reads1, lengths1, reads2=None,
                     lengths2=None, distro: Optional[torch.Tensor] = None,
                     n_chains: int = 4, stride: int = 8,
                     min_seed_len: int = 19, max_hits: int = 4,
                     params: SWParams = SWParams(), paired: bool = True,
                     kidx: KmerIndex = None):
    """One device step: phase-1 scoring for both ends, joint pair
    selection, split detection, extension, mate rescue and XA extension.
    Returns per end (Candidates, sub, sub_n, ScoredChains, XACompact)."""
    both = paired and reads2 is not None
    ends = [(reads1, lengths1)] + ([(reads2, lengths2)] if both else [])
    with _stage("seed_chain"):
        scs = weight_candidates(fm, ends, kidx, n_chains=n_chains,
                                stride=stride, min_seed_len=min_seed_len,
                                max_hits=max_hits)
    sc1, sc2 = scs[0], (scs[1] if both else None)
    k1 = k2 = None
    if sc2 is not None:
        with _stage("select"):
            if distro is None:
                distro = torch.tensor(DEFAULT_DISTRO, dtype=torch.float32,
                                      device=reads1.device)
            k1, k2 = _device_pair_select(sc1, sc2, distro)
    out = []
    for sc, reads, lengths, kk, other in (
        (sc1, reads1, lengths1, k1, (sc2, k2)),
        (sc2, reads2, lengths2, k2, (sc1, k1)),
    ):
        if sc is None:
            out.append(None)
            continue
        with _stage("select"):
            arp, aqp, ast, sub, sub_n, xa_mask = _device_choose(sc, lengths,
                                                                kk)
        with _stage("extend"):
            cand = extend_candidates(fm, reads, lengths, arp, aqp, ast,
                                     params=params)
        with _stage("rescue_xa"):
            if other[0] is not None:
                cand = _mate_rescue(fm, cand, sc, other[0], other[1], reads,
                                    lengths, distro, params)
            xa = _extend_xa(fm, sc, xa_mask, reads, lengths, params)
        out.append((cand, sub, sub_n, sc, xa))
    return tuple(out)


# ------------------------------------------------------- packed device I/O

CIGAR_HEAD = 16  # ops in the always-fetched cigar head slice


def fused_align_packed(fm: FMIndex, reads1, lengths1, reads2=None,
                       lengths2=None, distro=None, **kw):
    """fused_align_step with outputs packed for one device→host fetch:
    meta (E, 7, B, S) int32, cigar head (E, B, S, 16) int16, full cigar
    (E, B, S, MAX_OPS) int16, overflow () int32, stats (E, 4, B, K) int32,
    xa_meta (E, 9, C) int32, xa_cig (E, C, 16) int16 — the layout of
    speedseq_tpu.align.core.fused_align_packed."""
    res = fused_align_step(fm, reads1, lengths1, reads2, lengths2,
                           distro=distro, **kw)
    with _stage("pack"):
        dev = reads1.device
        metas, cigars, stats, xa_metas, xa_cigs = [], [], [], [], []
        max_nops = torch.zeros((), dtype=i32, device=dev)
        pk = lambda hi, lo: (hi.to(i32) << 16) | (lo.to(i32) & 0xFFFF)
        for end in res:
            if end is None:
                continue
            cand, sub, sub_n, sc, xa = end
            B, S = cand.pos.shape
            sub_b = sub[:, None].expand(B, S)
            sub_n_b = sub_n[:, None].expand(B, S)
            metas.append(torch.stack([
                cand.pos.to(i32), cand.rend_pos.to(i32),
                cand.rstart.to(i32),
                pk(cand.strand, cand.score),
                pk(cand.qbeg, cand.qend),
                pk(cand.n_ops, cand.nm),
                pk(sub_b, sub_n_b),
            ]))
            M = cand.cigar_ops.shape[-1]
            valid = (torch.arange(M, device=dev)[None, None, :]
                     < cand.n_ops[..., None])
            cigars.append(torch.where(
                valid, (cand.cigar_len << 4) | cand.cigar_ops,
                0).to(torch.int16))
            max_nops = torch.maximum(max_nops, torch.where(
                cand.score > 0, cand.n_ops, 0).amax().to(i32))
            stats.append(torch.stack(
                [sc.pos, sc.strand, sc.score, sc.rend_pos]).to(i32))
            xa_metas.append(torch.stack([
                xa.read_idx, xa.pos, xa.strand, xa.score, xa.qbeg, xa.qend,
                xa.rend_pos, xa.n_ops, xa.nm,
            ]).to(i32))
            xv = torch.arange(M, device=dev)[None, :] < xa.n_ops[:, None]
            xa_cigs.append(torch.where(
                xv, (xa.cigar_len << 4) | xa.cigar_ops, 0
            ).to(torch.int16)[:, :CIGAR_HEAD])
        cigar_full = torch.stack(cigars)
        overflow = (max_nops > CIGAR_HEAD).to(i32)
        xa_meta = torch.stack(xa_metas)
        xa_ok = xa_meta[:, 7] <= CIGAR_HEAD          # n_ops row
        xa_meta[:, 0] = torch.where(xa_ok, xa_meta[:, 0], -1)
        return (torch.stack(metas), cigar_full[..., :CIGAR_HEAD],
                cigar_full, overflow, torch.stack(stats), xa_meta,
                torch.stack(xa_cigs))


def fused_align_leaves(fm: FMIndex, reads1, lengths1, reads2=None,
                       lengths2=None, distro=None, **kw):
    """fused_align_packed with the per-batch fetch collapsed to two leaves:
    one int32 ([E,B,S,C header | meta | xa_meta | overflow]) and one int16
    ([cigar16 | xa_cig]); the full cigar and the stats stay separate."""
    meta, cig16, cigfull, ovf, stats, xam, xac = fused_align_packed(
        fm, reads1, lengths1, reads2, lengths2, distro=distro, **kw)
    with _stage("pack"):
        return pack_leaves(meta, cig16, ovf, xam, xac) + (cigfull, stats)


def pack_leaves(meta, cig16, ovf, xam, xac):
    """The two fetched leaves (int32, int16) of fused_align_leaves, from
    fused_align_packed's outputs (those of parallel.mesh.
    distributed_fused_step too)."""
    E, _, B, S = meta.shape
    C = xam.shape[2]
    hdr = torch.tensor([E, B, S, C], dtype=i32, device=meta.device)
    i32_leaf = torch.cat(
        [hdr, meta.reshape(-1), xam.reshape(-1), ovf.reshape(1)])
    i16_leaf = torch.cat([cig16.reshape(-1), xac.reshape(-1)])
    return i32_leaf, i16_leaf


def unpack_leaves(i32_leaf: np.ndarray, i16_leaf: np.ndarray):
    """(meta, xa_meta, overflow, cigar16, xa_cig) from the two fetched
    leaves of fused_align_leaves (self-describing header)."""
    E, B, S, C = (int(x) for x in i32_leaf[:4])
    at = 4
    meta = i32_leaf[at: at + E * 7 * B * S].reshape(E, 7, B, S)
    at += E * 7 * B * S
    xam = i32_leaf[at: at + E * 9 * C].reshape(E, 9, C)
    ovf = int(i32_leaf[-1])
    head = (len(i16_leaf) // (E * B * S + E * C))
    cig16 = i16_leaf[: E * B * S * head].reshape(E, B, S, head)
    xac = i16_leaf[E * B * S * head:].reshape(E, C, head)
    return meta, xam, ovf, cig16, xac


class PackedEnd(NamedTuple):
    """Host-side view of one end's packed fused output (numpy arrays)."""

    pos: np.ndarray
    strand: np.ndarray
    score: np.ndarray
    qbeg: np.ndarray
    qend: np.ndarray
    rend_pos: np.ndarray
    n_ops: np.ndarray
    rstart: np.ndarray
    nm: np.ndarray
    sub: np.ndarray      # (B,)
    sub_n: np.ndarray    # (B,)
    cigar_ops: np.ndarray   # (B, S, MAX_OPS) op codes
    cigar_len: np.ndarray   # (B, S, MAX_OPS) lengths


def unpack_fused(meta: np.ndarray, cigar: np.ndarray) -> list:
    """Split fetched packed arrays into per-end host views (paired rows hold
    two int16 fields per int32: hi<<16 | lo&0xFFFF)."""
    out = []

    def hi(v):
        return (v >> 16).astype(np.int32)

    def lo(v):
        return (v & 0xFFFF).astype(np.uint16).astype(np.int16).astype(
            np.int32)

    for e in range(meta.shape[0]):
        m = meta[e]
        out.append(PackedEnd(
            pos=m[0], rend_pos=m[1], rstart=m[2],
            strand=hi(m[3]), score=lo(m[3]),
            qbeg=hi(m[4]), qend=lo(m[4]),
            n_ops=hi(m[5]), nm=lo(m[5]),
            sub=hi(m[6])[:, 0], sub_n=lo(m[6])[:, 0],
            cigar_ops=cigar[e] & 0xF,
            cigar_len=cigar[e].astype(np.int32) >> 4,
        ))
    return out


class PackedXA(NamedTuple):
    """Host view of one end's compacted extra-XA lanes."""

    read_idx: np.ndarray
    pos: np.ndarray
    strand: np.ndarray
    score: np.ndarray
    qbeg: np.ndarray
    qend: np.ndarray
    rend_pos: np.ndarray
    n_ops: np.ndarray
    nm: np.ndarray
    cigar_ops: np.ndarray
    cigar_len: np.ndarray


def unpack_xa(xa_meta: np.ndarray, xa_cig: np.ndarray) -> list:
    """Per-end host views of the packed extra-XA lanes."""
    out = []
    for e in range(xa_meta.shape[0]):
        m = xa_meta[e]
        out.append(PackedXA(
            read_idx=m[0], pos=m[1], strand=m[2], score=m[3], qbeg=m[4],
            qend=m[5], rend_pos=m[6], n_ops=m[7], nm=m[8],
            cigar_ops=xa_cig[e] & 0xF,
            cigar_len=xa_cig[e].astype(np.int32) >> 4,
        ))
    return out


# ---------------------------------------------------------------- host side

class HostAlignment(NamedTuple):
    """One selected alignment (host, numpy scalars)."""

    pos: int
    strand: int
    score: int
    sub_score: int
    sub_n: int
    mapq: int
    cigar: list          # [(op, len)] incl. soft clips, strand frame
    nm: int
    md: str
    end_pos: int
    aligned: bool


_MAPQ_COEF = 6.02  # bwa mem_approx_mapq_se constants [external knowledge]


def mapq_vec(
    score: np.ndarray, sub: np.ndarray, sub_n: np.ndarray, qlen: np.ndarray,
    min_seed_len: int = 19, params: SWParams = SWParams(),
) -> np.ndarray:
    """BWA-MEM approximate single-end MAPQ, vectorised over (B, S) arrays."""
    a, b = params.match, params.mismatch
    score = score.astype(np.float64)
    sub = np.maximum(sub, min_seed_len * a).astype(np.float64)
    # padded lanes have qlen 0; clamp (their mapq is masked to 0 anyway
    # via score==0)
    l = np.maximum(qlen.astype(np.float64), 1.0)
    if score.ndim == 2:
        l = l[:, None]
    identity = 1.0 - (l * a - score) / (a + b) / l
    tmp = np.where(l < 50.0, 1.0, np.log(50.0) / np.log(np.maximum(l, 2.0)))
    tmp = tmp * identity * identity
    mapq = (_MAPQ_COEF * (score - sub) / a * tmp * tmp + 0.499).astype(np.int64)
    pen = (4.343 * np.log(sub_n + 1.0) + 0.499).astype(np.int64)
    mapq = np.where(sub_n > 0, mapq - pen, mapq)
    mapq = np.where((sub >= score) | (score == 0), 0, mapq)
    return np.clip(mapq, 0, 60).astype(np.int32)


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Selection(NamedTuple):
    """Host-side phase-1 selection for the extend pass."""

    anchor_rpos: np.ndarray   # (B, 2) int32; -1 = empty slot
    anchor_qpos: np.ndarray
    strand: np.ndarray
    sub: np.ndarray           # (B,) suboptimal score for MAPQ
    sub_n: np.ndarray         # (B,)


def choose_candidates(
    sc: ScoredChains,
    lengths_np: np.ndarray,
    chosen_k: Optional[np.ndarray] = None,
    min_out_score: int = 30,
    mask_level: float = 0.5,
    match: int = 1,
) -> Selection:
    """Pick primary (+ optional split supplementary) chain per read from
    phase-1 scores; computes MAPQ sub-score stats (the host twin of
    ``_device_choose``)."""
    score = _host(sc.score)
    pos = _host(sc.pos)
    rend = _host(sc.rend_pos)
    strand = _host(sc.strand)
    qb = _host(sc.qspan_beg)
    qe = _host(sc.qspan_end)
    arp = _host(sc.anchor_rpos)
    aqp = _host(sc.anchor_qpos)
    lengths_np = _host(lengths_np)
    B, K = score.shape
    kp = (_host(chosen_k).astype(int) if chosen_k is not None
          else np.argmax(score, axis=1))
    bidx = np.arange(B)
    sp = score[bidx, kp]
    # ref-overlap with the chosen candidate
    ovl = ~(
        (rend <= pos[bidx, kp][:, None]) | (pos >= rend[bidx, kp][:, None])
    )
    other = np.ones((B, K), bool)
    other[bidx, kp] = False
    live = other & (score > 0)
    non_ovl = live & ~ovl
    sub = np.where(non_ovl, score, 0).max(axis=1)
    sub_n = (non_ovl & (score >= (sp - 3 * match)[:, None])).sum(axis=1)
    # split supplementary: query-span disjoint candidates (orig frame)
    qlen = lengths_np[:, None]
    ob = np.where(strand == 1, qlen - qe, qb)
    oe = np.where(strand == 1, qlen - qb, qe)
    pb = ob[bidx, kp][:, None]
    pe = oe[bidx, kp][:, None]
    qov = np.maximum(
        0, np.minimum(pe, oe) - np.maximum(pb, ob)
    )
    shorter = np.maximum(1, np.minimum(pe - pb, oe - ob))
    split_ok = non_ovl & (score >= min_out_score) & (qov < mask_level * shorter)
    supp_score = np.where(split_ok, score, -1)
    ks = np.argmax(supp_score, axis=1)
    has_supp = supp_score[bidx, ks] > 0
    sel_rpos = np.stack(
        [arp[bidx, kp], np.where(has_supp, arp[bidx, ks], -1)], axis=1
    ).astype(np.int32)
    sel_qpos = np.stack(
        [aqp[bidx, kp], np.where(has_supp, aqp[bidx, ks], 0)], axis=1
    ).astype(np.int32)
    sel_strand = np.stack(
        [strand[bidx, kp], np.where(has_supp, strand[bidx, ks], 0)], axis=1
    ).astype(np.int32)
    return Selection(sel_rpos, sel_qpos, sel_strand, sub, sub_n)


def mapq_from_scores(
    score: int, sub: int, sub_n: int, qlen: int, min_seed_len: int = 19,
    params: SWParams = SWParams(), frac_rep: float = 0.0,
) -> int:
    """BWA-MEM approximate single-end MAPQ [external knowledge:
    mem_approx_mapq_se; reproduced to match bwa's mapq distribution]."""
    a, b = params.match, params.mismatch
    sub = max(sub, min_seed_len * a)
    if sub >= score:
        return 0
    l = qlen
    identity = 1.0 - float(l * a - score) / (a + b) / l
    if score == 0:
        return 0
    mapq_coef_len, mapq_coef_fac = 50.0, np.log(50.0)
    tmp = 1.0 if l < mapq_coef_len else mapq_coef_fac / np.log(l)
    tmp *= identity * identity
    mapq = int(_MAPQ_COEF * (score - sub) / a * tmp * tmp + 0.499)
    if sub_n > 0:
        mapq -= int(4.343 * np.log(sub_n + 1) + 0.499)
    mapq = max(0, min(60, mapq))
    return int(mapq * (1.0 - frac_rep) + 0.499)


def _cigar_with_clips(ops, lens, n_ops, qbeg, qend, qlen):
    cig = []
    if qbeg > 0:
        cig.append((4, int(qbeg)))  # S
    for o, l in zip(ops[:n_ops], lens[:n_ops]):
        if l > 0:
            cig.append((int(o), int(l)))
    if qlen - qend > 0:
        cig.append((4, int(qlen - qend)))
    return cig


def _nm_md(cigar, query, refwin, qbeg, rbeg):
    """NM distance + MD string by walking the cigar (htslib MD contract)."""
    nm = 0
    md = []
    run = 0
    qi, ri = qbeg, rbeg
    for op, ln in cigar:
        if op == 0:  # M
            for t in range(ln):
                qv, rv = int(query[qi + t]), int(refwin[ri + t])
                if qv == rv and qv < 4:
                    run += 1
                else:
                    md.append(str(run))
                    md.append("ACGTN"[min(rv, 4)])
                    run = 0
                    nm += 1
            qi += ln
            ri += ln
        elif op == 1:  # I
            nm += ln
            qi += ln
        elif op == 2:  # D
            md.append(str(run))
            run = 0
            md.append("^" + "".join("ACGTN"[min(int(refwin[ri + t]), 4)] for t in range(ln)))
            nm += ln
            ri += ln
        # soft clips don't touch MD/NM
    md.append(str(run))
    return nm, "".join(md)


def finalize_alignments(
    cand,
    reads_np: np.ndarray,
    lengths_np: np.ndarray,
    sub: np.ndarray,
    sub_n: np.ndarray,
    params: SWParams = SWParams(),
    min_seed_len: int = 19,
    min_out_score: int = 30,
    host_ref: Optional[np.ndarray] = None,
) -> list:
    """Finalize the 2-slot extend output (slot 0 primary, slot 1 supp)
    into (HostAlignment, Optional[HostAlignment]) per read.

    ``cand`` is a Candidates (tensors on any device, fetched here once;
    refwin only when some lane lacks a kernel NM) or a PackedEnd (numpy).
    When the kernel didn't supply NM, NM/MD are recomputed on host — from
    cand.refwin if present, else from ``host_ref`` (the unpacked forward
    reference, BWAIndex.pac)."""
    pos = _host(cand.pos)
    strand = _host(cand.strand)
    score = _host(cand.score)
    qbeg = _host(cand.qbeg)
    qend = _host(cand.qend)
    rend = _host(cand.rend_pos)
    ops = _host(cand.cigar_ops)
    lens = _host(cand.cigar_len)
    n_ops = _host(cand.n_ops)
    knm = _host(cand.nm)
    reads_np, lengths_np = _host(reads_np), _host(lengths_np)
    sub, sub_n = _host(sub), _host(sub_n)
    # refwin is only transferred off-device when some lane lacks a kernel
    # NM — the (B,K,W) window is the largest d2h payload
    lazy: dict = {}

    def _refwin():
        if "rw" not in lazy:
            lazy["rw"] = _host(cand.refwin)
            lazy["rs"] = _host(cand.rstart)
        return lazy["rw"], lazy["rs"]

    B, S = score.shape
    # vectorized MAPQ: slot 0 uses the real sub/sub_n stats; supplementary
    # slots use sub=0/sub_n=0 (bwa treats supplementary pieces the same)
    sub_full = np.zeros((B, S), np.int64)
    sub_full[:, 0] = sub
    sub_n_full = np.zeros((B, S), np.int64)
    sub_n_full[:, 0] = sub_n
    mapq_all = mapq_vec(
        np.asarray(score), sub_full, sub_n_full, np.asarray(lengths_np),
        min_seed_len, params,
    )
    unaligned = HostAlignment(-1, 0, 0, 0, 0, 0, [], 0, "", -1, False)
    out = []
    for b in range(B):
        qlen = int(lengths_np[b])

        def fin(k, sb, sn):
            s = int(score[b, k])
            mapq = int(mapq_all[b, k])
            cig = _cigar_with_clips(
                ops[b, k], lens[b, k], int(n_ops[b, k]),
                int(qbeg[b, k]), int(qend[b, k]), qlen,
            )
            if knm[b, k] >= 0:
                nm, md = int(knm[b, k]), ""
            else:
                q = reads_np[b][:qlen].astype(np.int32)
                if strand[b, k] == 1:
                    qr = q[::-1]
                    q = np.where(qr < 4, 3 - qr, 4)
                if hasattr(cand, "refwin"):
                    refwin, rstart = _refwin()
                    win, ri = refwin[b, k], int(pos[b, k] - rstart[b, k])
                else:
                    p = int(pos[b, k])
                    win, ri = host_ref[p:int(rend[b, k])], 0
                nm, md = _nm_md(
                    [c for c in cig if c[0] != 4], q, win,
                    int(qbeg[b, k]), ri,
                )
            return HostAlignment(
                pos=int(pos[b, k]), strand=int(strand[b, k]), score=s,
                sub_score=sb, sub_n=sn, mapq=mapq, cigar=cig, nm=nm, md=md,
                end_pos=int(rend[b, k]), aligned=True,
            )

        if score[b, 0] < min_out_score:
            out.append((unaligned, None))
            continue
        prim = fin(0, int(sub[b]), int(sub_n[b]))
        supp = None
        if score.shape[1] > 1 and score[b, 1] >= min_out_score and pos[b, 1] >= 0:
            # ref-overlapping second piece is not a split
            if rend[b, 1] <= pos[b, 0] or pos[b, 1] >= rend[b, 0]:
                supp = fin(1, 0, 0)
        out.append((prim, supp))
    return out


def _orig_frame(qbeg: int, qend: int, strand: int, qlen: int) -> Tuple[int, int]:
    """Map a strand-frame query interval back to original-read coords."""
    if strand == 0:
        return qbeg, qend
    return qlen - qend, qlen - qbeg


def select_alignments(
    cand: Candidates,
    reads_np: np.ndarray,
    lengths_np: np.ndarray,
    chosen_k: Optional[np.ndarray] = None,
    params: SWParams = SWParams(),
    min_seed_len: int = 19,
    min_out_score: int = 30,   # bwa -T
    mask_level: float = 0.5,   # bwa query-overlap threshold for secondary
    find_splits: bool = True,
) -> list:
    """Finalize one primary (+ optional supplementary split) per read.

    Returns a list of (HostAlignment, Optional[HostAlignment]); primary has
    aligned=False for unmapped reads.  ``chosen_k`` overrides the
    per-read candidate choice (joint pair selection).  The candidates'
    tensors (any device) are fetched once, refwin only when some lane
    lacks a kernel NM.
    """
    pos = _host(cand.pos)
    strand = _host(cand.strand)
    score = _host(cand.score)
    qbeg = _host(cand.qbeg)
    qend = _host(cand.qend)
    rend = _host(cand.rend_pos)
    ops = _host(cand.cigar_ops)
    lens = _host(cand.cigar_len)
    n_ops = _host(cand.n_ops)
    knm = _host(cand.nm)
    reads_np, lengths_np = _host(reads_np), _host(lengths_np)
    if chosen_k is not None:
        chosen_k = _host(chosen_k)
    lazy: dict = {}

    def _refwin():
        if "rw" not in lazy:
            lazy["rw"] = _host(cand.refwin)
            lazy["rs"] = _host(cand.rstart)
        return lazy["rw"], lazy["rs"]

    B, K = score.shape

    def finalize(b, k, qlen, sub, sub_n):
        s = int(score[b, k])
        mapq = mapq_from_scores(s, sub, sub_n, qlen, min_seed_len, params)
        cig = _cigar_with_clips(
            ops[b, k], lens[b, k], int(n_ops[b, k]),
            int(qbeg[b, k]), int(qend[b, k]), qlen,
        )
        if knm[b, k] >= 0:
            nm, md = int(knm[b, k]), ""
        else:
            refwin, rstart = _refwin()
            q = reads_np[b][:qlen].astype(np.int32)
            if strand[b, k] == 1:
                qr = q[::-1]
                q = np.where(qr < 4, 3 - qr, 4)
            nm, md = _nm_md(
                [c for c in cig if c[0] != 4],
                q,
                refwin[b, k],
                int(qbeg[b, k]),
                int(pos[b, k] - rstart[b, k]),
            )
        return HostAlignment(
            pos=int(pos[b, k]), strand=int(strand[b, k]), score=s,
            sub_score=sub, sub_n=sub_n, mapq=mapq, cigar=cig, nm=nm, md=md,
            end_pos=int(rend[b, k]), aligned=True,
        )

    unaligned = HostAlignment(-1, 0, 0, 0, 0, 0, [], 0, "", -1, False)
    out = []
    for b in range(B):
        qlen = int(lengths_np[b])
        k_best = int(chosen_k[b]) if chosen_k is not None else int(np.argmax(score[b]))
        s_best = int(score[b, k_best])
        if s_best < min_out_score:
            out.append((unaligned, None))
            continue
        qb_best, qe_best = _orig_frame(
            int(qbeg[b, k_best]), int(qend[b, k_best]),
            int(strand[b, k_best]), qlen,
        )
        # suboptimal stats + split detection over the other candidates
        sub, sub_n = 0, 0
        supp_k, supp_score = -1, 0
        for k in range(K):
            if k == k_best or score[b, k] <= 0:
                continue
            sk = int(score[b, k])
            ref_overlap = not (
                rend[b, k] <= pos[b, k_best] or pos[b, k] >= rend[b, k_best]
            )
            if not ref_overlap:
                sub = max(sub, sk)
                if sk >= s_best - params.match * 3:
                    sub_n += 1
            if find_splits and sk >= min_out_score and not ref_overlap:
                qb, qe = _orig_frame(
                    int(qbeg[b, k]), int(qend[b, k]), int(strand[b, k]), qlen
                )
                ov = max(0, min(qe_best, qe) - max(qb_best, qb))
                shorter = min(qe_best - qb_best, qe - qb)
                if shorter > 0 and ov < mask_level * shorter and sk > supp_score:
                    supp_k, supp_score = k, sk
        prim = finalize(b, k_best, qlen, sub, sub_n)
        supp = None
        if supp_k >= 0:
            supp = finalize(b, supp_k, qlen, 0, 0)
        out.append((prim, supp))
    return out
