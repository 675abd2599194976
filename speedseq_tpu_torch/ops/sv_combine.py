"""Per-cluster log-sum of member probability curves (sv's curve
combination): CUDA kernel and plain twin.

``combine_logsum`` gives acc (C, W) float32: for each cluster c and column
w, the sum over member rank r = 0 .. sizes[c] - 1, in that order, of the
member row's (first[c] + r) log curve on the cluster's union support,
``log(max(curve[row, w - (start[row] - lo[c])], 1e-12))`` inside the
member's curve and ``log(1e-12)`` outside.  That is the float32
``segment_sum`` of the JAX package's ``_combine_jit``
(``speedseq_tpu/sv/device.py:120``) taken in row order, the order of
the reference's sum on the CPU.

A CUDA tensor launches the hand kernel of ``csrc/sv_combine.cu`` (a block a
(cluster, column tile): log warps fill a shared buffer with a chunk of
members' log values while one thread a column adds the previous chunk's in
rank order; first and sizes go to it as int32 or as the int64 that
``torch.bincount`` gives, with no conversion; it raises if the launch
fails), a CPU tensor runs
``sv_combine_logsum_plain``, a loop over member ranks vectorised across
clusters, which is the kernel's executable specification (bit-equal on
the card: the same adds in the same order).  Any other device raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .nvcc_build import CSRC_DIR, build_library

EPS = 1e-12
MAX_W = 65535 * 128        # the kernel's widest tiles on the grid's y axis

# launches of the kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"sv_combine_logsum": 0}

SOURCE = os.path.join(CSRC_DIR, "sv_combine.cu")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/sv_combine.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.ssq_sv_combine_logsum,
                       lib.ssq_sv_combine_logsum_i64):
                fn.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, vp, vp]
                fn.restype = ci
            _lib = lib
    return _lib


def _check(first, sizes, lo, start, clen, curves, W):
    """C, after the inputs' shapes, W and one device are checked."""
    C, n = lo.shape[0], start.shape[0]
    if not (first.shape == sizes.shape == lo.shape == (C,)):
        raise ValueError("first, sizes and lo must be (C,) tensors")
    if clen.shape != (n,) or curves.dim() != 2 or curves.shape[0] != n:
        raise ValueError("start, clen (n,) and curves (n, D) expected")
    if curves.shape[1] < 1 or not 1 <= W <= MAX_W:
        raise ValueError(f"need D >= 1 and 1 <= W <= {MAX_W}, got "
                         f"D={curves.shape[1]} W={W}")
    dev = lo.device
    if (first.device != dev or sizes.device != dev or start.device != dev
            or clen.device != dev or curves.device != dev):
        raise ValueError("the inputs must share one device")
    return C


def combine_logsum(first, sizes, lo, start, clen, curves, W: int):
    """acc (C, W) float32 on the inputs' device (see the module note).
    Members of cluster c are the rows first[c] .. first[c] + sizes[c] - 1
    of start, clen and curves."""
    C = _check(first, sizes, lo, start, clen, curves, W)
    dev = lo.device
    if not lo.is_cuda:
        if dev.type == "cpu":
            return sv_combine_logsum_plain(first, sizes, lo, start, clen,
                                           curves, W)
        raise ValueError(f"unsupported device {dev}")
    acc = torch.empty((C, W), dtype=torch.float32, device=dev)
    if C == 0:
        return acc
    lib = _lib or _load()
    i32 = torch.int32
    # inputs already of the kernel's types and contiguous go as they are:
    # first and sizes int64 (as torch.bincount and cumsum give them) or
    # int32, the rest int32 and float32
    launch = lib.ssq_sv_combine_logsum
    if (first.dtype is torch.int64 and sizes.dtype is torch.int64
            and first.is_contiguous() and sizes.is_contiguous()):
        launch = lib.ssq_sv_combine_logsum_i64
    elif not (first.dtype is i32 and sizes.dtype is i32
              and first.is_contiguous() and sizes.is_contiguous()):
        first, sizes = (t.to(i32).contiguous() for t in (first, sizes))
    lo, start, clen = (t if t.dtype is i32 and t.is_contiguous()
                       else t.to(i32).contiguous() for t in (lo, start, clen))
    if curves.dtype is not torch.float32 or not curves.is_contiguous():
        curves = curves.to(torch.float32).contiguous()
    args = (first.data_ptr(), sizes.data_ptr(), lo.data_ptr(), C,
            start.data_ptr(), clen.data_ptr(), curves.data_ptr(),
            curves.shape[1], W, acc.data_ptr())
    idx = dev.index
    if idx == torch._C._cuda_getDevice():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(dev):   # the runtime launches on its device
            rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sv_combine_logsum launch failed: cudaError {rc}")
    LAUNCHES["sv_combine_logsum"] += 1
    return acc


def sv_combine_logsum_plain(first, sizes, lo, start, clen, curves, W: int):
    """Plain PyTorch twin of the kernel (any device): one step per member
    rank r, over every cluster with more than r members, in row order."""
    dev = lo.device
    C = lo.shape[0]
    D = curves.shape[1]
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    eps = torch.tensor(EPS, dtype=torch.float32, device=dev)
    log_eps = torch.log(eps)
    acc = torch.zeros((C, W), dtype=torch.float32, device=dev)
    sizes_h = sizes.cpu().numpy()
    # clusters sorted by size (stable: equal sizes keep cluster order), so
    # the live ones at rank r are a prefix
    order = torch.argsort(-sizes.long(), stable=True)
    n_active = [int((sizes_h > r).sum())
                for r in range(int(sizes_h.max()) if C else 0)]
    first = first.long()
    for r, k in enumerate(n_active):
        cl = order[:k]
        rows = first[cl] + r
        rel = col - (start[rows] - lo[cl])[:, None]
        inside = (rel >= 0) & (rel < clen[rows][:, None])
        vals = torch.gather(curves[rows], 1, rel.clamp(0, D - 1).long())
        logrow = torch.where(inside, torch.log(torch.maximum(vals, eps)),
                             log_eps)
        acc[cl] = acc[cl] + logrow
    return acc
