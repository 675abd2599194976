"""Batched local affine-gap Smith-Waterman entry points.

Counterpart of speedseq_tpu/align/sw.py.  The banded wrappers
(``banded_sw_pallas`` / ``banded_sw_score_pallas``) dispatch by the
tensors' device through ops/sw_banded.py: the CUDA kernel for a CUDA
tensor, the plain twin for a CPU tensor.  The kernels take any N (one warp
per alignment, bounds-checked), so nothing is padded.  The unbanded
score-only ``banded_sw_score`` (var's haplotype scorer) is torch tensor
code on either device.  Scoring follows bwa defaults (match 1, mismatch 4,
gap open 6, gap extend 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sw_banded


class SWParams(NamedTuple):
    match: int = 1        # bwa -A
    mismatch: int = 4     # bwa -B
    gap_open: int = 6     # bwa -O
    gap_ext: int = 1      # bwa -E


class SWResult(NamedTuple):
    score: torch.Tensor      # (N,) int32 best local score
    qbeg: torch.Tensor       # (N,) query start (inclusive)
    qend: torch.Tensor       # (N,) query end (exclusive)
    rbeg: torch.Tensor       # (N,) ref-window start (inclusive)
    rend: torch.Tensor       # (N,) ref-window end (exclusive)
    cigar_ops: torch.Tensor  # (N, MAX_OPS) int32, valid below n_ops
    cigar_len: torch.Tensor  # (N, MAX_OPS) int32
    n_ops: torch.Tensor      # (N,)
    gscore: torch.Tensor     # (N,) best score reaching the query end
    grend: torch.Tensor      # (N,) ref end (excl) of that path


class SWScore(NamedTuple):
    score: torch.Tensor
    qend: torch.Tensor
    rend: torch.Tensor
    gscore: torch.Tensor
    grend: torch.Tensor


def banded_sw_pallas(query, qlen, ref, params: SWParams = SWParams(),
                     max_ops: int = 48, with_nm: bool = False):
    """DP and traceback in one kernel launch.  With ``with_nm`` returns
    (SWResult, nm), nm being the edit distance along the path."""
    (score, qbeg, qend, rbeg, rend, gscore, grend, ops, lens, n_ops,
     nm) = sw_banded.sw_cigar(query, qlen, ref, params=tuple(params),
                              max_ops=max_ops)
    res = SWResult(
        score=score, qbeg=qbeg, qend=qend, rbeg=rbeg, rend=rend,
        cigar_ops=ops, cigar_len=lens, n_ops=n_ops, gscore=gscore,
        grend=grend,
    )
    return (res, nm) if with_nm else res


def banded_sw_score_pallas(query, qlen, ref,
                           params: SWParams = SWParams()) -> SWScore:
    """Score-only banded DP in one kernel launch."""
    return SWScore(*sw_banded.sw_score(query, qlen, ref, params=tuple(params)))


NEG = -(10**6)


def banded_sw_score(query: torch.Tensor, qlen: torch.Tensor,
                    ref: torch.Tensor,
                    params: SWParams = SWParams()) -> SWScore:
    """Unbanded score-only local SW, one loop step per query row on
    (N, Lr + 1) int32 tensors (the counterpart of the JAX package's XLA
    ``banded_sw_score``; var's haplotype scorer calls it).

    query (N, Lq) and ref (N, Lr) are base codes (4 = N / padding, which
    scores -1 against anything), qlen (N,) the live query length.  Within a
    row the deletion state is an exclusive prefix max, taken with
    ``torch.cummax`` over keys ``g * Lr + j`` (exact in int32).  The best
    cell is the first maximum in row-major order: a row's maximum replaces
    the running best only when strictly larger, and ``torch.max`` along a
    row returns the first maximal column."""
    N, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    go, ge = params.gap_open, params.gap_ext
    oe = go + ge
    query = query.to(torch.int32)
    qlen = qlen.to(torch.int32)
    ref = ref.to(torch.int32)
    ecol = torch.arange(Lr, dtype=torch.int32, device=dev)[None, :]
    ref_ok = ref < 4
    zcol = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    negcol = torch.full((N, 1), NEG, dtype=torch.int32, device=dev)
    exstart = torch.full((N, 1), -1, dtype=torch.int32, device=dev)
    H = torch.zeros((N, Lr + 1), dtype=torch.int32, device=dev)
    V = torch.full((N, Lr + 1), NEG, dtype=torch.int32, device=dev)
    bs = torch.zeros(N, dtype=torch.int32, device=dev)
    bq, br, gs, gr = (torch.zeros_like(bs) for _ in range(4))
    for i in range(Lq):
        qc = query[:, i:i + 1]
        sub = torch.where(
            (qc < 4) & ref_ok,
            torch.where(qc == ref, params.match, -params.mismatch),
            -1).to(torch.int32)
        diag = sub + H[:, :-1]
        Vr = torch.maximum(V[:, 1:] - ge, H[:, 1:] - oe)
        Ht = torch.clamp_min(torch.maximum(diag, Vr), 0)
        run = torch.cummax((Ht + ge * ecol) * Lr + ecol, dim=1).values
        run_ex = torch.cat([exstart, run[:, :-1]], dim=1)
        gmax = torch.where(run_ex >= 0,
                           torch.div(run_ex, Lr, rounding_mode="floor"), NEG)
        Hr = torch.maximum(Ht, gmax - go - ge * ecol)
        valid = (i < qlen)[:, None]
        Hr = torch.where(valid, Hr, 0)
        Vr = torch.where(valid, Vr, NEG)
        rowmax, rowmax_j = torch.max(Hr, dim=1)
        rowmax_j = rowmax_j.to(torch.int32) + 1
        better = rowmax > bs
        bs = torch.where(better, rowmax, bs)
        bq = torch.where(better, i + 1, bq)
        br = torch.where(better, rowmax_j, br)
        last = qlen == i + 1
        gs = torch.where(last, rowmax, gs)
        gr = torch.where(last, rowmax_j, gr)
        H = torch.cat([zcol, Hr], dim=1)
        V = torch.cat([negcol, Vr], dim=1)
    return SWScore(score=bs, qend=bq, rend=br, gscore=gs, grend=gr)
