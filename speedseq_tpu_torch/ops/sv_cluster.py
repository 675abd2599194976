"""Cluster sweep over sorted LUMPY evidence: CUDA kernel and plain twin.

``cluster_scan`` gives each evidence row its cluster id, exactly as the JAX
package's serial scan (``speedseq_tpu/sv/device.py:_cluster_scan_jit``):
rows sorted by (gid, start1, start2); a row starts a new cluster when the
gid changes or when it fails the 2-D overlap test against the running
extents of the current cluster (max end1, min lo2, max hi2).

A CUDA tensor launches the hand kernels of ``csrc/sv_cluster.cu`` (the
rows split at forced breaks, found by a max-scan of packed (gid, end1)
keys; one thread walks each piece between them; an integer scan turns
the cluster starts into ids), with no host sync; it raises if a launch
fails.  A CPU tensor runs ``cluster_scan_plain``, a loop over row ranks
vectorised across segments, which is the kernels' executable
specification.  There is no fallback from one to the other.

``cluster_extents`` gives the per-cluster [lo, hi) span of one breakpoint
side (segment min/max over cluster ids, exact in int32).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from .nvcc_build import CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "sv_cluster.cu")
# dependent operations per row on the kernel's carry chain (em, l2, h2):
# the overlap test's three compares (independent of each other), the and
# that combines them, and the select of each extent (its max/min against
# the row runs beside the compares; the counter feeds no later test) --
# the figure chip_smoke.py's serial-chain bound uses, over the longest
# piece between forced breaks
CHAIN_OPS_PER_ROW = 3
# rows of one tile of the multi-block sweep (csrc/sv_cluster.cu TILE_ROWS)
TILE_ROWS = 1024

# launches of the kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"sv_cluster": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/sv_cluster.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ssq_sv_cluster.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp,
                                           vp, vp]
            lib.ssq_sv_cluster.restype = ci
            _lib = lib
    return _lib


def _check(cols) -> int:
    n = cols[0].shape[0]
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError("gid, s1, e1, lo2, hi2 must be (n,) tensors")
        if c.device != cols[0].device:
            raise ValueError("gid, s1, e1, lo2, hi2 must share one device")
    return n


def segments(gid: torch.Tensor) -> torch.Tensor:
    """First row of each run of equal gid (int32, on gid's device)."""
    brk = torch.ones_like(gid, dtype=torch.bool)
    brk[1:] = gid[1:] != gid[:-1]
    return torch.nonzero(brk).flatten().to(torch.int32)


def _globalise(local, count, seg_start, n):
    """Segment-local ids + per-segment counts -> global cluster ids."""
    offs = torch.cumsum(count.long(), 0) - count.long()
    lens = torch.diff(seg_start.long(), append=seg_start.new_tensor([n]).long())
    return (local.long() + torch.repeat_interleave(offs, lens)).to(torch.int32)


def cluster_scan(gid, s1, e1, lo2, hi2) -> torch.Tensor:
    """Cluster id (int32) of every row of evidence sorted by (gid, start1,
    start2); e1 = start1 + len1, lo2 = start2, hi2 = start2 + len2.  On
    cuda, gid must be int32-valued and non-decreasing (the sort gives
    that)."""
    n = _check((gid, s1, e1, lo2, hi2))
    dev = gid.device
    if dev.type == "cpu":
        return cluster_scan_plain(gid, s1, e1, lo2, hi2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if n > 2**31 - 2 * TILE_ROWS:
        raise ValueError(f"{n} rows: more than the sweep's int32 row "
                         f"indices hold")
    lib = _load()
    cols = [t.to(torch.int32).contiguous() for t in (gid, s1, e1, lo2, hi2)]
    nb = (n + TILE_ROWS - 1) // TILE_ROWS
    tile_key = torch.empty(nb, dtype=torch.int64, device=dev)
    tile_count = torch.empty(nb, dtype=torch.int32, device=dev)
    g, a, b, c, d = (t.data_ptr() for t in cols)
    with torch.cuda.device(dev):   # the runtime launches on its device
        rc = lib.ssq_sv_cluster(
            g, n, a, b, c, d, tile_key.data_ptr(), tile_count.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sv_cluster launch failed: cudaError {rc}")
    LAUNCHES["sv_cluster"] += 1
    return out


def cluster_scan_plain(gid, s1, e1, lo2, hi2) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (any device): the same carry,
    stepped over row rank r, every segment's r-th row at once."""
    n = _check((gid, s1, e1, lo2, hi2))
    dev = gid.device
    i32 = torch.int32
    if n == 0:
        return torch.zeros(0, dtype=i32, device=dev)
    s1, e1, lo2, hi2 = (t.to(i32) for t in (s1, e1, lo2, hi2))
    seg_start = segments(gid)
    lens = torch.diff(seg_start, append=seg_start.new_tensor([n]))
    S = seg_start.shape[0]
    em = torch.zeros(S, dtype=i32, device=dev)
    l2, h2, cid = em.clone(), em.clone(), em.clone()
    local = torch.zeros(n + 1, dtype=i32, device=dev)   # row n: dump slot
    for r in range(int(lens.max())):
        act = lens > r
        i = torch.where(act, seg_start + r, n).long()
        ic = i.clamp(max=n - 1)
        s, e, lo, hi = s1[ic], e1[ic], lo2[ic], hi2[ic]
        ov = (s < em) & (lo < h2) & (hi > l2) & (r > 0)
        cid = torch.where(act & ~ov, cid + 1, cid)
        em = torch.where(act, torch.where(ov, torch.maximum(em, e), e), em)
        l2 = torch.where(act, torch.where(ov, torch.minimum(l2, lo), lo), l2)
        h2 = torch.where(act, torch.where(ov, torch.maximum(h2, hi), hi), h2)
        local[i] = cid - 1
    return _globalise(local[:n], cid, seg_start, n)


def cluster_extents(cids: torch.Tensor, start: torch.Tensor,
                    end: torch.Tensor, n_clusters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster lo = min(start) and hi = max(end) (int32)."""
    idx = cids.long()
    z = torch.zeros(n_clusters, dtype=torch.int32, device=cids.device)
    lo = z.scatter_reduce(0, idx, start.to(torch.int32), "amin",
                          include_self=False)
    hi = z.scatter_reduce(0, idx, end.to(torch.int32), "amax",
                          include_self=False)
    return lo, hi
