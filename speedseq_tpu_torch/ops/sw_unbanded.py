"""Unbanded local affine-gap Smith-Waterman: CUDA kernels and plain twins.

``sw_score_unbanded`` (var's and somatic's haplotype scan) computes
exactly what the JAX package's XLA scan
``speedseq_tpu/align/sw.py:banded_sw_score`` computes, one alignment a
lane: no band, the deletion state an exclusive prefix max of Ht + e*j
over the whole row, ambiguous bases (a code of 4 or more) scoring -1
against anything, the best cell the first maximum in row-major order
(a row's maximum replaces the running best only when strictly larger, at
the row's first maximal column), gscore/grend from row qlen - 1.

``sw_cigar_unbanded`` (the unfused alignment API's extension,
align/core.py:align_candidates) computes exactly what the JAX package's
``speedseq_tpu/align/sw.py:banded_sw`` computes: the same DP (its
deletion source the arg of the exclusive prefix max of the value-major
key (Ht + e*j) * Lr + j, so a tie takes the largest column), the best
cell the first maximum over all Lq rows, then banded_sw's traceback
state machine; all ten SWResult fields.

A CUDA tensor launches a hand kernel of ``csrc/sw_unbanded.cu`` (one block
an alignment; it raises if the launch fails), a CPU tensor runs the plain
twin (``sw_score_unbanded_plain``, ``sw_cigar_unbanded_plain``), a loop of
tensor ops a query row, which is the kernel's executable specification.
Any other device raises.  There is no fallback from one to the other.

Shapes: query (N, Lq) and ref (N, Lr) codes, qlen (N,).
- The scan takes Lr up to ``max_width(params)`` on every device (32,768
  at bwa scoring): past it the int32 key (Ht + e*j) * Lr + j of the twin,
  and of the JAX scan, no longer holds its value exactly.  The kernel also
  needs Lq <= Lr and gap penalties >= 0; it keeps R query rows a thread in
  registers and sweeps the window's columns (``scan_layout``): the narrow
  entry up to Lr = 1024, the wide one above, with the stripe buffers in a
  device scratch where a block cannot hold them.
- The traceback DP takes Lr <= 256 on every device (banded_sw stores the
  deletion distance as uint8) and Lq >= 1; its kernel keeps a lane's
  direction codes in shared memory, 128 bytes a row: Lq <= 1792 on cuda.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .nvcc_build import CSRC_DIR, build_library

NEG = -(10 ** 6)
MAX_LR = 1024                 # the narrow entry's widest window
SCAN_ROWS = (1, 2, 3, 4, 5, 6, 8)   # the kernel's R (rows a thread)
SCAN_WARPS = 8                # warps a block above one stripe
SCAN_COLS = 4                 # columns a thread takes a wavefront step
SMEM_MAX = 232_448            # shared memory one block may take on sm_90
CIGAR_MAX_LR = 256
CIGAR_MAX_LQ = 1792
CIGAR_MAX_OPS = 64
INT32_MAX = 2 ** 31 - 1

# int32 instructions a cell, the essential work that the roofline bound in
# chip_smoke.py counts against Hopper's issue rate (an operation that one
# instruction does with its neighbour counts once): the substitution 1 (a
# byte-table lookup, as ops/sw_banded.py counts it), the vertical move 2
# (H - o - e, then add-then-max with V - e), Ht 2 (H + sub, a 3-input max
# with V and 0), the prefix max 1 (add-then-max of Ht + e j into the
# running max), H 1 (add-then-max of pm - o - e j with Ht), the row max 1
# = 8.
OPS_PER_CELL = 8

# the traceback DP's forward pass, int32 instructions a cell: the scan's
# 8, the vertical-extend bit 1, the direction 3 (diag - H, V - H and a
# logic op on their signs), the record bit 1 and packing the 4-bit code
# into the row's word 2 = 15.  The walk, at most Lq + Lr steps a lane, is
# not counted.
OPS_PER_CELL_CIGAR = 15

# launches of each kernel since the last reset (plain-twin calls not
# counted); the wide scan counts as sw_unbanded_score
LAUNCHES = {"sw_unbanded_score": 0, "sw_unbanded_cigar": 0}

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
            lib.ssq_sw_unbanded_score_wide.argtypes = [
                vp, vp, vp] + [ci] * 9 + [vp, cl, vp, vp]
            lib.ssq_sw_unbanded_score_wide.restype = ci
            lib.ssq_sw_unbanded_cigar.argtypes = [
                vp, vp, vp] + [ci] * 8 + [vp, cl, vp, vp, vp]
            lib.ssq_sw_unbanded_cigar.restype = ci
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


def max_width(params=(1, 4, 6, 1)) -> int:
    """The widest window the scan takes: the largest Lr whose largest key
    (Ht + e j) * Lr + j stays an int32, with Ht <= match * Lr (a local
    score gains at most match a window column) and j <= Lr - 1."""
    m, e = max(params[0], 0), max(params[3], 0)
    key = lambda L: (m * L + e * (L - 1)) * L + L - 1
    L = int((INT32_MAX / max(m + e, 1)) ** 0.5) + 2
    while key(L) > INT32_MAX:
        L -= 1
    return L


def check_width(Lr: int, params=(1, 4, 6, 1)) -> None:
    """Raises ValueError above ``max_width(params)``, on every device."""
    top = max_width(params)
    if Lr > top:
        raise ValueError(f"the scan takes Lr <= {top} at these scores "
                         f"(its int32 key wraps past it), got Lr={Lr}")


def check_kernel_shape(Lq: int, Lr: int, params=(1, 4, 6, 1)) -> None:
    """Raises ValueError unless the kernel takes (Lq, Lr) and the
    scoring: Lq <= Lr <= max_width(params), gap open and extension >= 0
    (the kernel carries V and the deletion state from H, not Ht, and lets
    the cells past the window run on, which is exact only there)."""
    check_width(Lr, params)
    if Lq > Lr:
        raise ValueError(f"the kernel needs Lq <= Lr, got Lq={Lq} Lr={Lr}")
    if min(params[2], params[3]) < 0:
        raise ValueError(f"the kernel needs gap open and extension >= 0, "
                         f"got {tuple(params)}")


def scan_layout(Lq: int, warps: int = SCAN_WARPS) -> tuple:
    """(R, warps) of the scan kernel, as csrc/sw_unbanded.cu's narrow
    entry picks it: one warp and one stripe of 32 R rows, R the fewest of
    SCAN_ROWS that hold the query, up to 256 rows; above, stripes of 256
    rows (R = 8) on up to ``warps`` warps a block."""
    if Lq <= 256:
        return next(R for R in SCAN_ROWS if 32 * R >= Lq), 1
    return 8, min(-(-Lq // 256), warps)


def scan_smem_bytes(Lq: int, Lr: int, R: int, warps: int) -> tuple:
    """(fixed, buffers): the shared memory a block of the scan takes
    (its head, a warp's hand-off slots, the window's codes), and the bytes
    of its stripe buffers (warps x Lr columns x (H, V) int32, rows padded
    to 4 columns) where the query takes more than one stripe; the wrapper
    keeps the buffers in shared memory where both fit in SMEM_MAX, else in
    a device scratch."""
    Lp = -(-Lr // 4) * 4
    return (128 + 2048 * warps + 4 * Lp,
            8 * warps * Lp if Lq > 32 * R else 0)


def sw_score_unbanded(query, qlen, ref, params=(1, 4, 6, 1)):
    """Returns (score, qend, rend, gscore, grend), (N,) int32 each."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    check_width(Lr, params)
    dev = query.device
    if dev.type == "cpu":
        return sw_score_unbanded_plain(query, qlen, ref, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_kernel_shape(Lq, Lr, params)
    lib = _load()
    q, ql, r = (t.to(torch.int32).contiguous() for t in (query, qlen, ref))
    out = torch.empty((5, N), dtype=torch.int32, device=dev)
    if N:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):   # the runtime launches on its device
            if Lr <= MAX_LR:
                rc = lib.ssq_sw_unbanded_score(
                    q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr,
                    *params, out.data_ptr(), N, stream)
            else:
                R, warps = scan_layout(Lq)
                fixed, buf = scan_smem_bytes(Lq, Lr, R, warps)
                scratch = (None if fixed + buf <= SMEM_MAX
                           else torch.empty(N * buf, dtype=torch.uint8,
                                            device=dev))
                rc = lib.ssq_sw_unbanded_score_wide(
                    q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr, R,
                    warps, *params, out.data_ptr(), N,
                    None if scratch is None else scratch.data_ptr(), stream)
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


def check_cigar_shape(Lq: int, Lr: int, max_ops: int, cuda: bool,
                      params=(1, 4, 6, 1)) -> None:
    """Raises ValueError unless the traceback DP takes (Lq, Lr, max_ops)
    and, on cuda, the scoring's gap penalties (open, ext >= 0: the kernel
    lets the cells past the window run on unmasked, which needs them)."""
    if Lq < 1 or not 1 <= Lr <= CIGAR_MAX_LR:
        raise ValueError(f"the traceback DP needs Lq >= 1 and 1 <= Lr <= "
                         f"{CIGAR_MAX_LR} (deletion distances are uint8), "
                         f"got Lq={Lq} Lr={Lr}")
    if cuda and (Lq > CIGAR_MAX_LQ or not 1 <= max_ops <= CIGAR_MAX_OPS):
        raise ValueError(f"the kernel needs Lq <= {CIGAR_MAX_LQ} and "
                         f"1 <= max_ops <= {CIGAR_MAX_OPS}, got Lq={Lq} "
                         f"max_ops={max_ops}")
    if cuda and min(params[2], params[3]) < 0:
        raise ValueError(f"the kernel needs gap open and extension >= 0, "
                         f"got {tuple(params)}")


def sw_cigar_unbanded(query, qlen, ref, params=(1, 4, 6, 1), max_ops=48):
    """Returns (score, qbeg, qend, rbeg, rend, cigar_ops, cigar_len, n_ops,
    gscore, grend): (N,) int32, but cigar_ops (N, max_ops) int8 (-1
    padding) and cigar_len (N, max_ops) int32 (0 padding)."""
    N, Lq, Lr = _check_inputs(query, qlen, ref)
    dev = query.device
    check_cigar_shape(Lq, Lr, max_ops, dev.type == "cuda", params)
    if dev.type == "cpu":
        return sw_cigar_unbanded_plain(query, qlen, ref, params, max_ops)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load()
    q, ql, r = (t.to(torch.int32).contiguous() for t in (query, qlen, ref))
    out = torch.empty((8, N), dtype=torch.int32, device=dev)
    ops = torch.empty((N, max_ops), dtype=torch.int8, device=dev)
    lens = torch.empty((N, max_ops), dtype=torch.int32, device=dev)
    if N:
        with torch.cuda.device(dev):
            rc = lib.ssq_sw_unbanded_cigar(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), N, Lq, Lr,
                *params, max_ops, out.data_ptr(), N, ops.data_ptr(),
                lens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sw_unbanded_cigar launch failed: "
                               f"cudaError {rc}")
        with _lock:
            LAUNCHES["sw_unbanded_cigar"] += 1
    score, qbeg, qend, rbeg, rend, n_ops, gscore, grend = out
    return score, qbeg, qend, rbeg, rend, ops, lens, n_ops, gscore, grend


def sw_cigar_unbanded_plain(query, qlen, ref, params=(1, 4, 6, 1),
                            max_ops=48):
    """Plain PyTorch twin of the traceback kernel (any device), banded_sw
    step for step: one loop step a query row keeps each cell's direction
    (0 stop, 1 diag, 2 I, 3 D; ties diag > I > D; 0 where H <= 0), its
    vertical-extend bit and its deletion distance j - gsrc (uint8) in
    (N, Lq, Lr) tensors and the first maximum in row-major order; then the
    traceback runs a fixed Lq + Lr steps of its state machine (mode 1, in
    an I-run, forces a vertical step; a deletion run is one jump; past
    max_ops ops the last slot takes every new op while its length keeps
    adding), and the ops built end to start are reversed."""
    match, mismatch, go, ge = params
    N, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    oe = go + ge
    i32, u8 = torch.int32, torch.uint8
    query, qlen, ref = (t.to(i32) for t in (query, qlen, ref))
    ecol = torch.arange(Lr, dtype=i32, device=dev)[None, :]
    ref_ok = ref < 4
    zcol = torch.zeros((N, 1), dtype=i32, device=dev)
    negcol = torch.full((N, 1), NEG, dtype=i32, device=dev)
    exstart = torch.full((N, 1), -1, dtype=i32, device=dev)
    H = torch.zeros((N, Lr + 1), dtype=i32, device=dev)
    V = torch.full((N, Lr + 1), NEG, dtype=i32, device=dev)
    dirs = torch.zeros((N, Lq, Lr), dtype=u8, device=dev)
    vexts = torch.zeros((N, Lq, Lr), dtype=u8, device=dev)
    ddists = torch.zeros((N, Lq, Lr), dtype=u8, device=dev)
    bs = torch.zeros(N, dtype=i32, device=dev)
    bi, bj, gs, gj = (torch.zeros_like(bs) for _ in range(4))
    last_row = (qlen - 1).clamp(0, Lq - 1)
    for i in range(Lq):
        qc = query[:, i:i + 1]
        sub = torch.where((qc < 4) & ref_ok,
                          torch.where(qc == ref, match, -mismatch),
                          -1).to(i32)
        diag = sub + H[:, :-1]
        Vr = torch.maximum(V[:, 1:] - ge, H[:, 1:] - oe)
        vext = V[:, 1:] - ge >= H[:, 1:] - oe
        Ht = torch.clamp_min(torch.maximum(diag, Vr), 0)
        run = torch.cummax((Ht + ge * ecol) * Lr + ecol, dim=1).values
        run_ex = torch.cat([exstart, run[:, :-1]], dim=1)
        gmax = torch.where(run_ex >= 0,
                           torch.div(run_ex, Lr, rounding_mode="floor"), NEG)
        gsrc = torch.where(run_ex >= 0, torch.remainder(run_ex, Lr), 0)
        F = gmax - go - ge * ecol
        Hr = torch.maximum(Ht, F)
        pos = Hr > 0
        d = torch.where((Hr == F) & pos, 3, 0)
        d = torch.where((Hr == Vr) & pos, 2, d)
        d = torch.where((Hr == diag) & pos, 1, d)
        valid = (i < qlen)[:, None]
        Hr = torch.where(valid, Hr, 0)
        Vr = torch.where(valid, Vr, NEG)
        dirs[:, i] = torch.where(valid, d, 0).to(u8)
        vexts[:, i] = vext.to(u8)
        ddists[:, i] = (ecol - gsrc).clamp(0, 255).to(u8)
        rowmax, rowj = torch.max(Hr, dim=1)
        rowj = rowj.to(i32)
        better = rowmax > bs
        bs = torch.where(better, rowmax, bs)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, rowj, bj)
        last = last_row == i
        gs = torch.where(last, rowmax, gs)
        gj = torch.where(last, rowj, gj)
        H = torch.cat([zcol, Hr], dim=1)
        V = torch.cat([negcol, Vr], dim=1)

    dirs, vexts, ddists = (a.reshape(N, Lq * Lr) for a in (dirs, vexts,
                                                           ddists))
    i, j = bi.clone(), bj.clone()
    mode = torch.zeros_like(bi)
    kop = torch.zeros_like(bi)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    ops = torch.full((N, max_ops), -1, dtype=i32, device=dev)
    lens = torch.zeros((N, max_ops), dtype=i32, device=dev)
    for _ in range(Lq + Lr):
        cell = (i.clamp(0, Lq - 1) * Lr + j.clamp(0, Lr - 1)).long()[:, None]
        d = dirs.gather(1, cell)[:, 0].to(i32)
        ve = vexts.gather(1, cell)[:, 0] > 0
        dd = ddists.gather(1, cell)[:, 0].to(i32)
        oob = (i < 0) | (j < 0)
        d_eff = torch.where(mode == 1, 2, torch.where(oob, 0, d))
        now_done = (d_eff == 0) | done
        is_diag = (d_eff == 1) & ~now_done
        is_vert = (d_eff == 2) & ~now_done
        is_horiz = (d_eff == 3) & ~now_done
        op = torch.where(is_diag, 0, torch.where(is_vert, 1, 2)).to(i32)
        step_len = torch.where(is_horiz, dd.clamp_min(1), 1)
        prev_k = (kop - 1).clamp(0, max_ops - 1).long()[:, None]
        prev_op = ops.gather(1, prev_k)[:, 0]
        merge = (kop > 0) & (prev_op == op) & ~now_done
        write_k = torch.where(merge[:, None], prev_k,
                              kop.clamp(0, max_ops - 1).long()[:, None])
        ops.scatter_(1, write_k, torch.where(
            now_done, ops.gather(1, write_k)[:, 0], op)[:, None])
        lens.scatter_add_(1, write_k,
                          torch.where(now_done, 0, step_len)[:, None])
        kop = torch.where(now_done | merge, kop, kop + 1)
        mode2 = torch.where(is_vert & ve, 1, 0)
        i2 = torch.where(is_diag | is_vert, i - 1, i)
        j2 = torch.where(is_diag, j - 1, torch.where(is_horiz, j - step_len,
                                                     j))
        i = torch.where(now_done, i, i2).to(i32)
        j = torch.where(now_done, j, j2).to(i32)
        mode = torch.where(now_done, mode, mode2).to(i32)
        done = now_done
    src = kop[:, None] - 1 - torch.arange(max_ops, dtype=i32, device=dev)
    src_c = src.clamp(0, max_ops - 1).long()
    ops_f = torch.where(src >= 0, ops.gather(1, src_c), -1).to(torch.int8)
    lens_f = torch.where(src >= 0, lens.gather(1, src_c), 0).to(i32)
    return (bs, i + 1, bi + 1, j + 1, bj + 1, ops_f, lens_f, kop, gs,
            gj + 1)
