"""Unbanded score-only local affine-gap Smith-Waterman: CUDA kernel and
plain twin (var's and somatic's haplotype scan).

``sw_score_unbanded`` computes exactly what the JAX package's XLA scan
``speedseq_tpu/align/sw.py:banded_sw_score`` computes, one alignment a
lane: no band, the deletion state an exclusive prefix max of Ht + e*j
over the whole row, ambiguous bases (a code of 4 or more) scoring -1
against anything, the best cell the first maximum in row-major order
(a row's maximum replaces the running best only when strictly larger, at
the row's first maximal column), gscore/grend from row qlen - 1.

A CUDA tensor launches the hand kernel of ``csrc/sw_unbanded.cu`` (one
warp an alignment, the row in registers; it raises if the launch fails),
a CPU tensor runs ``sw_score_unbanded_plain``, a loop of tensor ops a
query row, which is the kernel's executable specification.  Any other
device raises.  There is no fallback from one to the other.

Shapes: query (N, Lq) and ref (N, Lr) codes, qlen (N,).  The kernel
takes Lq <= Lr <= 1024 and a CUDA tensor of any other shape raises; the
twin takes any Lq and Lr >= 1.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .nvcc_build import CSRC_DIR, build_library

NEG = -(10 ** 6)
MAX_LR = 1024

# int32 instructions a cell, the essential work that the roofline bound in
# chip_smoke.py counts against Hopper's issue rate (an operation that one
# instruction does with its neighbour counts once): the substitution 1 (a
# byte-table lookup, as ops/sw_banded.py counts it), the vertical move 2
# (H - o - e, then add-then-max with V - e), Ht 2 (H + sub, a 3-input max
# with V and 0), the prefix max 1 (add-then-max of Ht + e j into the
# running max), H 1 (add-then-max of pm - o - e j with Ht), the row max 1
# = 8.
OPS_PER_CELL = 8

# launches of the kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"sw_unbanded_score": 0}

SOURCE = os.path.join(CSRC_DIR, "sw_unbanded.cu")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/sw_unbanded.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.ssq_sw_unbanded_score.argtypes = [
                vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, cl, vp]
            lib.ssq_sw_unbanded_score.restype = ci
            _lib = lib
    return _lib


def _check_inputs(query, qlen, ref):
    if query.dim() != 2 or ref.dim() != 2 or qlen.dim() != 1:
        raise ValueError("query (N, Lq), qlen (N,), ref (N, Lr) expected")
    N, Lq = query.shape
    if ref.shape[0] != N or qlen.shape[0] != N:
        raise ValueError("query, qlen and ref disagree on N")
    Lr = ref.shape[1]
    if Lr < 1:
        raise ValueError(f"need Lr >= 1, got Lr={Lr}")
    if not (query.device == qlen.device == ref.device):
        raise ValueError("query, qlen and ref must share one device")
    return N, Lq, Lr


def check_kernel_shape(Lq: int, Lr: int) -> None:
    """Raises ValueError unless the kernel takes (Lq, Lr): Lq <= Lr <=
    MAX_LR (its row is held in registers, at most 32 columns a thread)."""
    if not Lq <= Lr <= MAX_LR:
        raise ValueError(f"the kernel needs Lq <= Lr <= {MAX_LR}, got "
                         f"Lq={Lq} Lr={Lr}")


def sw_score_unbanded(query, qlen, ref, params=(1, 4, 6, 1)):
    """Returns (score, qend, rend, gscore, grend), (N,) int32 each."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    dev = query.device
    if dev.type == "cpu":
        return sw_score_unbanded_plain(query, qlen, ref, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_kernel_shape(Lq, Lr)
    lib = _load()
    q, ql, r = (t.to(torch.int32).contiguous() for t in (query, qlen, ref))
    out = torch.empty((5, N), dtype=torch.int32, device=dev)
    if N:
        with torch.cuda.device(dev):   # the runtime launches on its device
            rc = lib.ssq_sw_unbanded_score(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr,
                *params, out.data_ptr(), N,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sw_unbanded_score launch failed: "
                               f"cudaError {rc}")
        with _lock:        # var -t N launches from N host threads
            LAUNCHES["sw_unbanded_score"] += 1
    return tuple(out)


def sw_score_unbanded_plain(query, qlen, ref, params=(1, 4, 6, 1)):
    """Plain PyTorch twin of the kernel (any device): one loop step per
    query row on (N, Lr + 1) int32 tensors.  Within a row the deletion
    state is an exclusive prefix max, taken with ``torch.cummax`` over keys
    ``g * Lr + j`` (exact in int32); ``torch.max`` along a row returns the
    first maximal column."""
    match, mismatch, gap_open, gap_ext = params
    N, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    go, ge = gap_open, gap_ext
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
            torch.where(qc == ref, match, -mismatch),
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
    return bs, bq, br, gs, gr
