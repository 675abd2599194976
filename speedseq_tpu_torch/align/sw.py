"""Batched local affine-gap Smith-Waterman entry points.

Counterpart of speedseq_tpu/align/sw.py.  The banded wrappers
(``banded_sw_pallas`` / ``banded_sw_score_pallas``) dispatch by the
tensors' device through ops/sw_banded.py, the unbanded score-only
``banded_sw_score`` (var's haplotype scorer) and the unbanded DP with
traceback ``banded_sw`` (the unfused alignment API's extension) through
ops/sw_unbanded.py: the CUDA kernel for a CUDA tensor, the plain twin for
a CPU tensor.  The kernels take any N (one warp per alignment,
bounds-checked), so nothing is padded.  Scoring follows bwa defaults (match 1, mismatch 4,
gap open 6, gap extend 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sw_banded, sw_unbanded


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
    cigar_ops: torch.Tensor  # (N, MAX_OPS) valid below n_ops (int32;
    #                          int8 with -1 padding from banded_sw)
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


def banded_sw_score(query: torch.Tensor, qlen: torch.Tensor,
                    ref: torch.Tensor,
                    params: SWParams = SWParams()) -> SWScore:
    """Unbanded score-only local SW (the counterpart of the JAX package's
    XLA ``banded_sw_score``; var's haplotype scorer calls it), in one
    launch of the hand kernel on a CUDA tensor, its plain twin on a CPU
    tensor (ops/sw_unbanded.py).

    query (N, Lq) and ref (N, Lr) are base codes (4 = N / padding, which
    scores -1 against anything), qlen (N,) the live query length.  Every
    device takes Lr up to ``ops/sw_unbanded.py:max_width(params)`` (32,768
    at bwa scoring, where the int32 key of the JAX scan stops being exact)
    and raises past it; the kernel also needs Lq <= Lr.  The best cell is
    the first maximum in row-major order."""
    return SWScore(*sw_unbanded.sw_score_unbanded(query, qlen, ref,
                                                  params=tuple(params)))


def banded_sw(query: torch.Tensor, qlen: torch.Tensor, ref: torch.Tensor,
              params: SWParams = SWParams(), max_ops: int = 48) -> SWResult:
    """Local alignment of each query lane against its own ref window, with
    traceback (the counterpart of the JAX package's XLA ``banded_sw``; no
    band, no deletion cap), in one launch of the hand kernel
    ``ssq_sw_unbanded_cigar`` on a CUDA tensor, its plain twin on a CPU
    tensor (ops/sw_unbanded.py).

    query (N, Lq) int codes (4 = N / padding), qlen (N,), ref (N, Lr)
    codes (4 = out of range), Lr <= 256 (the deletion distance is a uint8,
    as in the JAX function).  cigar_ops (N, max_ops) int8 with -1 padding,
    cigar_len int32 with 0 padding; n_ops may exceed max_ops, whose last
    slot then holds the last op written."""
    return SWResult(*sw_unbanded.sw_cigar_unbanded(
        query, qlen, ref, params=tuple(params), max_ops=max_ops))
