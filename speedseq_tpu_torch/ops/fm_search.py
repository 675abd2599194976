"""FMD-index search for FM (SMEM) seeding: CUDA kernels and plain twins.

Two kernels, hand-written for Hopper in ``csrc/fm_search.cu``:

- ``fm_smem``: per (read, anchor) lane, the forward then the backward
  extension loop of ``speedseq_tpu/align/seeding.py:find_seeds`` (its two
  ``lax.while_loop``s) in one loop of the lane's thread, one launch per
  call with no host sync.  A step reads one checkpoint row and one
  16-byte half-block when both ranks of the interval fall in that half,
  counting up from the block's checkpoint or down from the next one's,
  else two lookups with all their loads in flight together; it counts only
  the base's class and the classes above it (the source's head note);
- ``fm_sa_walk``: per rank, the LF walk of ``speedseq_tpu/index/fm.py:
  sa_lookup`` (its 32-step ``fori_loop``) for indexes without a full SA.
  A step's three loads (a checkpoint, a half-block, a mark word) come
  from one 64-byte record of the index (``index/fm.py:walk_records``) and
  are issued together.

Each wrapper dispatches by device: a CUDA tensor launches the kernel (and
raises if the launch fails), a CPU tensor runs the plain PyTorch twin
(``fm_smem_plain`` / ``fm_sa_walk_plain``), a loop over the same tensors
built from ``index/fm.py``'s occ and extension functions, which is the
kernel's executable specification and the oracle on the card.  There is no
fallback from one to the other.  The library is built with ``nvcc`` on
first use (``ops/nvcc_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional

import torch

from ..index.fm import (_M32, SA_POS_INTV, FMIndex, BiInterval,
                        _popcount32, backward_ext, bwt_char, forward_ext,
                        interval_init, occ_all)
from .nvcc_build import CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "fm_search.cu")

# Operations the functions need (chip_smoke.py's bound), counted as the
# least work of the function rather than as the kernel does it.  One occ
# lookup of rank r for the counts of one or two base classes: rank adjust
# 2, block and offset 2; per packed word read (WORDS_PER_OCC on average:
# ceil(within/16) of 8, within uniform over 0-127) the odd-bit shift 1 and,
# per popcount, a three-input mask and an add 2; the last word, partial in
# PARTIAL_PER_OCC of lookups, its prefix mask 3.
WORDS_PER_OCC = 4.4375
PARTIAL_PER_OCC = 0.9375


def occ_ops(popcs: int):
    """(int32 operations, popcounts) of one lookup taking ``popcs``
    popcounts a word."""
    return (4 + WORDS_PER_OCC * (1 + 2 * popcs) + 3 * PARTIAL_PER_OCC,
            WORDS_PER_OCC * popcs)


# popcounts a word of one backward-extension lookup by base c needs: the
# count of c, and for l the count of the bases above c (c = 0 takes it
# from s - sentinel - cnt[0], c = 3 has none; c = 1 and 2 read one
# more class: hi bits, or hi & lo)
POPCS_FOR_BASE = (1, 2, 2, 1)
# one extension step besides its two lookups: the base read and its tests
# 2, the sentinel test 3, the new size and its test 2, the upper sum 2,
# the new k and l 3, the query bound and the loop 4
OPS_PER_STEP = 16
# one LF step of the walk besides its one-class lookup: the mark test 3,
# bwt_char 6, C[c] + occ 4; per rank: the first mark test 3, the sample's
# index 4 (one popcount) and the result 1
OPS_PER_WALK_STEP = 13
OPS_PER_WALK_RANK = 8
# dependent operations on a lane's carry per extension step (rank adjust,
# clamp, block, the gather, the summed counts, the pick, the new rank)
CHAIN_OPS_PER_STEP = 20

# launches of each kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"fm_smem": 0, "fm_sa_walk": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


class SmemLanes(NamedTuple):
    """Per (read, anchor) lane, flattened read-major: (B * G,) each."""

    qbeg: torch.Tensor    # int32 SMEM start in the read
    qend: torch.Tensor    # int32 SMEM end (exclusive)
    k: torch.Tensor       # int32 bi-interval k after the backward phase
    s: torch.Tensor       # int32 bi-interval size (occurrences)
    alive0: torch.Tensor  # bool: the anchor base opened an interval


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/fm_search.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ssq_fm_smem.argtypes = [
                vp, vp, ci, ci, vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp,
                vp, vp, vp]
            lib.ssq_fm_smem.restype = ci
            lib.ssq_fm_sa_walk.argtypes = [
                vp, ci, vp, vp, ci, ci, vp, vp, vp, ci, vp, vp]
            lib.ssq_fm_sa_walk.restype = ci
            _lib = lib
    return _lib


def _check_fm(fm: FMIndex, dev: torch.device) -> None:
    if fm.bwt is None:
        raise ValueError("the FMIndex carries no FMD arrays "
                         "(build it with FMIndex.from_bwa_fm)")
    for t in (fm.count, fm.occ_ckpt, fm.bwt, fm.sa_mark, fm.sa_ckpt,
              fm.sa_vals) + ((fm.walk_rec,) if fm.walk_rec is not None
                             else ()):
        if t.device != dev:
            raise ValueError(f"FMD arrays on {t.device}, queries on {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("FMD arrays must be contiguous int32")


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _index_args(fm: FMIndex):
    return (fm.count.data_ptr(), fm.occ_ckpt.data_ptr(), fm.bwt.data_ptr(),
            fm.bwt.shape[0], fm.primary, fm.seq_len)


# ----------------------------------------------------------------- wrappers

def fm_smem(fm: FMIndex, reads: torch.Tensor, lengths: torch.Tensor,
            starts: torch.Tensor) -> SmemLanes:
    """SMEM through each anchor: reads (B, L) base codes (4 = N/pad),
    lengths (B,), starts (G,) anchor positions; lanes read-major."""
    if reads.dim() != 2 or lengths.shape != reads.shape[:1] \
            or starts.dim() != 1:
        raise ValueError("reads (B, L), lengths (B,), starts (G,) expected")
    dev = reads.device
    if not (lengths.device == starts.device == dev):
        raise ValueError("reads, lengths and starts must share one device")
    if dev.type == "cpu":
        return fm_smem_plain(fm, reads, lengths, starts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_fm(fm, dev)
    B, L = reads.shape
    G = starts.shape[0]
    n = B * G
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    alive0 = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return SmemLanes(*out, alive0)
    lib = _load()
    r8 = reads.to(torch.uint8).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    with torch.cuda.device(dev):   # the runtime launches on its device
        rc = lib.ssq_fm_smem(
            r8.data_ptr(), ln.data_ptr(), B, L, st.data_ptr(), G,
            *_index_args(fm), *(t.data_ptr() for t in out),
            alive0.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(rc, "fm_smem")
    LAUNCHES["fm_smem"] += 1
    return SmemLanes(*out, alive0)


def walk_args(fm: FMIndex):
    """The index arguments of ``ssq_fm_sa_walk``: count, the walk records,
    primary, seq_len and the SA samples."""
    return (fm.count.data_ptr(), fm.walk_rec.data_ptr(), fm.primary,
            fm.seq_len, fm.sa_mark.data_ptr(), fm.sa_ckpt.data_ptr(),
            fm.sa_vals.data_ptr(), fm.sa_vals.shape[0])


def fm_sa_walk(fm: FMIndex, ranks: torch.Tensor) -> torch.Tensor:
    """SA value (int32) of each rank in [1, seq_len] by the LF walk.  On
    cuda the index must carry its walk records (``from_bwa_fm`` builds
    them for a cuda index without the full SA; ``walk_records`` for any)."""
    dev = ranks.device
    if dev.type == "cpu":
        return fm_sa_walk_plain(fm, ranks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_fm(fm, dev)
    if fm.walk_rec is None:
        raise ValueError("the FMIndex carries no walk records (build them "
                         "with index.fm.walk_records)")
    flat = ranks.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty_like(flat)
    if flat.numel() == 0:
        return out.reshape(ranks.shape)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ssq_fm_sa_walk(
            flat.data_ptr(), flat.numel(), *walk_args(fm), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(rc, "fm_sa_walk")
    LAUNCHES["fm_sa_walk"] += 1
    return out.reshape(ranks.shape)


# ------------------------------------------------------------ plain twins

def fm_smem_plain(fm: FMIndex, reads: torch.Tensor, lengths: torch.Tensor,
                  starts: torch.Tensor) -> SmemLanes:
    """Plain PyTorch twin of ``fm_smem`` (any device): the JAX package's
    two loops, every lane stepped together until none is alive (one host
    sync per step)."""
    B, L = reads.shape
    G = starts.shape[0]
    i64 = torch.int64
    reads = reads.to(i64)
    rlen = lengths.to(i64)[:, None]
    p = starts.to(i64)[None, :].expand(B, G)
    pf = p.reshape(-1)

    def read_base(off):
        vals = torch.gather(reads, 1, off.clamp(0, L - 1))
        return torch.where((off >= 0) & (off < rlen), vals, 4).reshape(-1)

    def keep(ok, new, old):
        return BiInterval(*(torch.where(ok, a, b) for a, b in zip(new, old)))

    c0 = read_base(p)
    iv = interval_init(fm, c0)
    alive0 = (c0 < 4) & (iv.s > 0)
    qend = torch.where(alive0, pf + 1, pf)
    alive, j = alive0, 1
    while j < L and bool(alive.any()):
        c = read_base(p + j)
        ext = forward_ext(fm, iv, c)
        ok = alive & (c < 4) & (ext.s > 0)
        iv = keep(ok, ext, iv)
        qend = torch.where(ok, pf + j + 1, qend)
        alive, j = ok, j + 1
    qbeg = pf
    alive, j = alive0, 1
    while j <= L and bool(alive.any()):
        c = read_base(p - j)
        ext = backward_ext(fm, iv, c)
        ok = alive & (c < 4) & (ext.s > 0)
        iv = keep(ok, ext, iv)
        qbeg = torch.where(ok, pf - j, qbeg)
        alive, j = ok, j + 1
    i32 = torch.int32
    return SmemLanes(qbeg.to(i32), qend.to(i32), iv.k.to(i32), iv.s.to(i32),
                     alive0)


def fm_sa_walk_plain(fm: FMIndex, ranks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``fm_sa_walk`` (any device): the fixed
    32-step LF walk of the JAX ``sa_lookup``.  Every 32nd text position is
    marked and each LF step moves one position left, so a mark is met
    within SA_POS_INTV steps.  ranks: (...,) in [1, seq_len]."""
    rr = ranks.to(torch.int64)
    steps = torch.zeros_like(rr)
    done = torch.zeros_like(rr, dtype=torch.bool)

    def mark_word(r):
        return fm.sa_mark[r // 32].to(torch.int64) & _M32

    for _ in range(SA_POS_INTV):
        done = done | (((mark_word(rr) >> (rr % 32)) & 1) == 1)
        c = bwt_char(fm, rr).to(torch.int64)
        lf = fm.count[c] + occ_all(fm, rr).gather(-1, c[..., None])[..., 0]
        rr = torch.where(done, rr, lf.to(torch.int64))
        steps = torch.where(done, steps, steps + 1)
    below = (torch.ones_like(rr) << (rr % 32)) - 1
    at = fm.sa_ckpt[rr // 32].to(torch.int64) + _popcount32(
        mark_word(rr) & below)
    return (fm.sa_vals[at.clamp(0, fm.sa_vals.shape[0] - 1)]
            + steps).to(torch.int32)
