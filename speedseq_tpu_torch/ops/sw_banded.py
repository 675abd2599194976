"""Banded local affine-gap Smith-Waterman: CUDA kernels and plain twins.

Two kernels, hand-written for Hopper in ``csrc/sw_banded.cu``:

- ``sw_cigar``: banded DP plus in-kernel traceback (replaces the Pallas
  ``sw_pallas_cigar`` of the JAX package);
- ``sw_score``: the same DP, score-only (replaces ``sw_pallas``).

Each wrapper takes int32 tensors and dispatches by device: a CUDA tensor
launches the kernel (and raises if the launch fails), a CPU tensor runs the
plain PyTorch twin (``sw_cigar_plain`` / ``sw_score_plain``), which is the
executable specification of the kernel and the oracle the card is checked
against.  There is no fallback from one to the other.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface on first use (keyed by a hash of the source, under
``ops/build/``) and loaded with ``ctypes``.

DP contract (both): query (N, Lq) codes 0-3 with 4 = N/pad, qlen (N,),
ref window (N, Lr) codes 0-4 (a code above 4 also scores as N, a negative
one as a mismatch against every base), with Lq <= Lr <= 256.  Band state is indexed by
c = j - i in [0, 128); scoring (match, mismatch, open, extend), ambiguous
bases score -1; the deletion state is a prefix max capped at 64 columns.
Best cell = max score, then smallest i, then smallest j.

The twin's traceback walks a packed direction word per cell, the
specification as the Pallas kernel writes it: bits 0-1 source (0 stop,
1 diag, 2 ins, 3 del), bit 2 I-extend, bit 3 D-extend, bit 4 mismatch,
bits 5-11 diagonal run length, bits 12-18 run mismatches (both saturating
at 127).  The CUDA kernel keeps only bits 0-3, a 4-bit code a cell in
shared memory, and its walk re-derives a diagonal cell's run and run
mismatches from the codes and the staged query and window (the head note
of csrc/sw_banded.cu).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .nvcc_build import CSRC_DIR, build_library

BAND = 128          # diagonal band width (c = j - i)
MAX_DEL = 64        # deletion prefix-max window (6 doubling steps)
NEG = -(10 ** 6)
MAX_OPS_CAP = 64    # op buffer of the traceback kernel (two slots a lane)

# int32 instructions per band cell, the essential work that the roofline
# bound in chip_smoke.py counts against Hopper's issue rate: an operation
# that one instruction does with its neighbour counts once (multiply-add,
# add-then-max, 3-input max, 3-input logic).  The score-only function:
# substitution 1 (a byte-table lookup), vertical move 2 (H - o - e, then
# add-then-max with V - e), Ht 2 (H + sub, a 3-input max with V and 0),
# the capped deletion window 3 (a sliding maximum of 64 columns at 3 a
# cell by van Herk / Gil-Werman, with x = Ht + e c folded into its two
# running maxima as add-then-max), H 1 (add-then-max of pm - o - e c with
# Ht), best-cell key 2 (a multiply-add, a max) = 11.  The traceback adds
# a 4-bit direction code a cell: the move 5 (diag - H, V - H and -H, then
# two 3-input logic ops whose signs are its two bits), the I-extend bit 1
# (the sign of Hv - Vv - o - 1, a 3-input add), the D-extend bit 1 (pm[c]
# == pm[c-1]), shifting it into the stored code 1 = 8, so 19 a cell for
# the cigar function.  The run length and run mismatches of the twin's
# word are not counted: the walk re-derives them at the cells it visits.
OPS_PER_CELL_SCORE = 11
OPS_PER_CELL_CIGAR = 19

# launches of each kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"sw_cigar": 0, "sw_score": 0}

SOURCE = os.path.join(CSRC_DIR, "sw_banded.cu")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/sw_banded.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.ssq_sw_cigar.argtypes = [
                vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp, cl, vp, vp,
                vp]
            lib.ssq_sw_cigar.restype = ci
            lib.ssq_sw_cigar_smem.argtypes = [ci]
            lib.ssq_sw_cigar_smem.restype = ci
            lib.ssq_sw_score.argtypes = [
                vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, cl, vp]
            lib.ssq_sw_score.restype = ci
            _lib = lib
    return _lib


def cigar_smem_bytes(Lq: int) -> int:
    """Dynamic shared bytes a block of the cigar kernel takes at this Lq
    (builds the library)."""
    return _load().ssq_sw_cigar_smem(Lq)


def _check_inputs(query, qlen, ref):
    if query.dim() != 2 or ref.dim() != 2 or qlen.dim() != 1:
        raise ValueError("query (N, Lq), qlen (N,), ref (N, Lr) expected")
    N, Lq = query.shape
    if ref.shape[0] != N or qlen.shape[0] != N:
        raise ValueError("query, qlen and ref disagree on N")
    Lr = ref.shape[1]
    if not (Lq <= Lr <= 256):
        raise ValueError(f"need Lq <= Lr <= 256, got Lq={Lq} Lr={Lr}")
    if not (query.device == qlen.device == ref.device):
        raise ValueError("query, qlen and ref must share one device")
    return N, Lq, Lr


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# ----------------------------------------------------------------- wrappers

def sw_cigar(query, qlen, ref, params=(1, 4, 6, 1), max_ops: int = 48):
    """Banded DP + traceback.  Returns (score, qbeg, qend, rbeg, rend,
    gscore, grend, ops, lens, n_ops, nm); ops/lens are (N, max_ops) int32 in
    alignment order, valid below n_ops (0 beyond)."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    if query.device.type == "cpu":
        return sw_cigar_plain(query, qlen, ref, params, max_ops)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    if not 1 <= max_ops <= MAX_OPS_CAP:
        raise ValueError(f"max_ops must be in [1, {MAX_OPS_CAP}]")
    lib = _load()
    q, ql, r = _i32(query), _i32(qlen), _i32(ref)
    dev = q.device
    out = torch.empty((9, N), dtype=torch.int32, device=dev)
    ops = torch.empty((N, max_ops), dtype=torch.int32, device=dev)
    lens = torch.empty((N, max_ops), dtype=torch.int32, device=dev)
    if N:
        with torch.cuda.device(dev):   # the runtime launches on its device
            rc = lib.ssq_sw_cigar(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr,
                *params, max_ops, out.data_ptr(), N, ops.data_ptr(),
                lens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _launch_check(rc, "sw_cigar")
        LAUNCHES["sw_cigar"] += 1
    score, qbeg, qend, rbeg, rend, gscore, grend, n_ops, nm = out
    return score, qbeg, qend, rbeg, rend, gscore, grend, ops, lens, n_ops, nm


def sw_score(query, qlen, ref, params=(1, 4, 6, 1)):
    """Score-only banded DP.  Returns (score, qend, rend, gscore, grend)."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    if query.device.type == "cpu":
        return sw_score_plain(query, qlen, ref, params)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    lib = _load()
    q, ql, r = _i32(query), _i32(qlen), _i32(ref)
    out = torch.empty((5, N), dtype=torch.int32, device=q.device)
    if N:
        with torch.cuda.device(q.device):
            rc = lib.ssq_sw_score(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr,
                *params, out.data_ptr(), N,
                torch.cuda.current_stream(q.device).cuda_stream)
        _launch_check(rc, "sw_score")
        LAUNCHES["sw_score"] += 1
    return tuple(out)


# ------------------------------------------------------------ plain twins

def _shift_right(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[:, c] = x[:, c - s] for c >= s, NEG below (the masked lane roll)."""
    fill = torch.full((x.shape[0], s), NEG, dtype=x.dtype, device=x.device)
    return torch.cat([fill, x[:, :-s]], dim=1)


def _dp(query, qlen, ref, params, with_dirs: bool):
    """Row loop shared by both twins; returns (best, gbest, dirs)."""
    p_match, p_mis, p_open, p_ext = params
    oe = p_open + p_ext
    N, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    i32 = torch.int32
    q = query.to(i32)
    ql = qlen.to(i32)[:, None]
    # columns past the window read as 4 (N)
    rpad = torch.cat(
        [ref.to(i32), torch.full((N, Lq + BAND), 4, dtype=i32, device=dev)], 1)
    col = torch.arange(BAND, dtype=i32, device=dev)[None, :]
    zero = torch.zeros((N, BAND), dtype=i32, device=dev)
    neg_col = torch.full((N, 1), NEG, dtype=i32, device=dev)
    H, V = zero, zero + NEG
    best, gbest, runs, misrun = zero, zero, zero, zero
    dirs = (torch.empty((N, Lq, BAND), dtype=i32, device=dev)
            if with_dirs else None)
    for i in range(Lq):
        qc = q[:, i:i + 1]
        refw = rpad[:, i:i + BAND]
        q_ok, r_ok = qc < 4, refw < 4
        is_match = q_ok & r_ok & (refw == qc)
        sub = torch.where(q_ok & r_ok,
                          torch.where(is_match, p_match, -p_mis), -1).to(i32)
        diag = H + sub
        Hv = torch.cat([H[:, 1:], neg_col], 1)
        Vv = torch.cat([V[:, 1:], neg_col], 1)
        a, b = Vv - p_ext, Hv - oe
        Vn = torch.maximum(a, b)
        vext = (a >= b).to(i32)
        Ht = torch.clamp_min(torch.maximum(diag, Vn), 0)
        x = Ht + p_ext * col
        s = 1
        while s < min(BAND, MAX_DEL):
            x = torch.maximum(x, _shift_right(x, s))
            s *= 2
        pm = _shift_right(x, 1)
        F = pm - p_open - p_ext * col
        Hn = torch.maximum(Ht, F)
        d = torch.zeros_like(Hn)
        d = torch.where((Hn == F) & (Hn > 0), 3, d)
        d = torch.where((Hn == Vn) & (Hn > 0), 2, d)
        d = torch.where((Hn == diag) & (Hn > 0), 1, d)
        valid = i < ql
        Hn = torch.where(valid, Hn, 0)
        Vn = torch.where(valid, Vn, NEG)
        if with_dirs:
            fext = ((pm == _shift_right(pm, 1)) & (col > 0)).to(i32)
            mis = (~is_match).to(i32)
            is_d = d == 1
            runs = torch.where(is_d, torch.clamp_max(runs + 1, 127), 0)
            misrun = torch.where(is_d, torch.clamp_max(misrun + mis, 127), 0)
            packed = (d | (vext << 2) | (fext << 3) | (mis << 4)
                      | (runs << 5) | (misrun << 12))
            dirs[:, i] = torch.where(valid, packed, 0)
        jg = i + col
        cand = (Hn * (Lq + 1) + (Lq - i)) * Lr + (Lr - 1 - jg)
        best = torch.maximum(best, cand)
        gbest = torch.where(i == ql - 1, Hn * Lr + (Lr - 1 - jg), gbest)
        H, V = Hn, Vn
    return best.amax(1), gbest.amax(1), dirs


def _decode(best, gbest, Lq: int, Lr: int):
    # the reduced keys are >= 0, so the kernel's truncating C division
    # agrees with the floor division used here
    if bool((best < 0).any()) or bool((gbest < 0).any()):
        raise AssertionError("negative best-cell key")
    M = (Lq + 1) * Lr
    rem = best % M
    score = best // M
    qend = Lq - rem // Lr + 1
    rend = Lr - 1 - rem % Lr + 1
    return score, qend, rend, gbest // Lr, Lr - 1 - gbest % Lr + 1


def sw_score_plain(query, qlen, ref, params=(1, 4, 6, 1)):
    """Plain PyTorch twin of the score-only kernel (any device)."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    best, gbest, _ = _dp(query, qlen, ref, params, with_dirs=False)
    return _decode(best, gbest, Lq, Lr)


def sw_cigar_plain(query, qlen, ref, params=(1, 4, 6, 1), max_ops: int = 48):
    """Plain PyTorch twin of the traceback kernel (any device): the same DP,
    then the traceback walk vectorised over lanes."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    best, gbest, dirs = _dp(query, qlen, ref, params, with_dirs=True)
    score, qend, rend, gscore, grend = _decode(best, gbest, Lq, Lr)
    dev = query.device
    i32 = torch.int32
    lane = torch.arange(N, device=dev)
    i, j = qend - 1, rend - 1
    zero = torch.zeros(N, dtype=i32, device=dev)
    mode, kop, cur_len, nm = zero, zero, zero, zero
    cur_op = zero - 1
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    ops = torch.zeros((N, max_ops + 1), dtype=i32, device=dev)
    lens = torch.zeros((N, max_ops + 1), dtype=i32, device=dev)
    for _ in range(Lq + Lr):
        if bool(done.all()):
            break
        act = ~done
        ii = i.clamp(0, Lq - 1).long()
        cc = (j - i).clamp(0, BAND - 1).long()
        p = dirs[lane, ii, cc]
        d, ve, fe = p & 3, (p >> 2) & 1, (p >> 3) & 1
        oob = (i < 0) | (j < 0) | (j - i < 0) | (j - i >= BAND)
        de = torch.where(mode == 1, 2,
                         torch.where(mode == 2, 3, torch.where(oob, 0, d)))
        fin = de == 0
        op = torch.where(de == 1, 0, torch.where(de == 2, 1, 2)).to(i32)
        step = torch.where(de == 1, torch.clamp_min((p >> 5) & 127, 1), 1)
        # a jump's mismatches are those of the rows it covers: the run's
        # count here less its count at the landing cell, which lies inside
        # the run only when the run is longer than the 127-row jump
        land = dirs[lane, (i - step).clamp(0, Lq - 1).long(), cc]
        land_mis = torch.where(i - step >= 0, (land >> 12) & 127, 0)
        nm_add = torch.where(de == 1, ((p >> 12) & 127) - land_mis, 1)
        change = ~fin & (cur_len > 0) & (op != cur_op)
        flush = act & (change | (fin & (cur_len > 0)))
        # slot max_ops is a dump column for lanes that do not flush
        kf = torch.where(flush, kop.clamp(0, max_ops - 1), max_ops).long()
        ops[lane, kf] = cur_op
        lens[lane, kf] = cur_len
        kop = torch.where(flush, kop + 1, kop)
        mv = act & ~fin
        cur_len = torch.where(
            act, torch.where(fin, 0, torch.where(change, step, cur_len + step)),
            cur_len).to(i32)
        cur_op = torch.where(mv, op, cur_op)
        nm = torch.where(mv, nm + nm_add, nm).to(i32)
        i = torch.where(mv & (de == 1), i - step,
                        torch.where(mv & (de == 2), i - 1, i)).to(i32)
        j = torch.where(mv & (de == 1), j - step,
                        torch.where(mv & (de == 3), j - 1, j)).to(i32)
        mode = torch.where(
            mv, torch.where((de == 2) & (ve == 1), 1,
                            torch.where((de == 3) & (fe == 1), 2, 0)),
            mode).to(i32)
        done = done | (act & fin)
    n = kop.clamp(0, max_ops)
    idx = torch.arange(max_ops, device=dev)[None, :]
    src = torch.where(idx < n[:, None], n[:, None] - 1 - idx, max_ops).long()
    ops = torch.gather(ops, 1, src)
    lens = torch.gather(lens, 1, src)
    valid = idx < n[:, None]
    ops = torch.where(valid, ops, 0)
    lens = torch.where(valid, lens, 0)
    return (score, i + 1, qend, j + 1, rend, gscore, grend, ops, lens,
            n.to(i32), nm)
