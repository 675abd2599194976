"""Hash k-mer seeding and NMS chaining (the align step's ``seed_chain``
stage): CUDA kernel and plain twin.

``seed_chain`` takes one or two ends of reads and gives, per end, the
top-``n_chains`` chains of ``chain_seeds_nms(find_seeds_hash(...))`` with
weight_candidates' ``pos`` and ``rend_pos`` (anchor diagonal plus the
chain's query span).

A CUDA tensor launches the hand kernel of ``csrc/seed_chain.cu`` once for
all ends (a block a read: seeding on both strands with each anchor's bucket
gathers issued together, the live seeds compacted in shared memory, the
rounds as block-wide reductions; no device scratch, no host sync; it raises
if the launch fails).  A CPU tensor runs ``seed_chain_plain``, the
composition ``index/kmer.py:find_seeds_hash`` → ``align/chain.py:
chain_seeds_nms``, which is the kernel's executable specification: every
output bit-equal.  Any other device raises.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..align.chain import Chains, chain_seeds_nms
from ..index.kmer import KmerIndex, find_seeds_hash
from ..utils.metrics import metrics
from .nvcc_build import CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "seed_chain.cu")
# the kernel's int32 output rows (csrc/seed_chain.cu), valid apart
FIELDS = ("anchor_rpos", "anchor_qpos", "anchor_len", "strand", "weight",
          "qspan_beg", "qspan_end", "pos", "rend_pos")
MAX_SCAN = 32          # bucket entries an anchor: one lane each, in a warp
SMEM_LIMIT = 232_448   # dynamic shared memory a Hopper block may use
# int32 instructions of one pair test in a round (diagonal difference, its
# absolute value, the compare with the band and the live flag, the select):
# chip_smoke.py's bound counts the first round's live same-strand pairs
OPS_PER_PAIR = 4

# launches of the kernel since the last reset (plain-twin calls not counted)
LAUNCHES = {"seed_chain": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}

End = Tuple[Chains, torch.Tensor, torch.Tensor]   # chains, pos, rend_pos


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose_ptxas: bool = False) -> str:
    """Compile csrc/seed_chain.cu (once per source hash); returns the .so
    path.  Records seconds and the ptxas report in BUILD_INFO."""
    return build_library(SOURCE, BUILD_INFO, verbose_ptxas)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            # PyDLL keeps the GIL through the launch (a few microseconds):
            # released, the dispatching thread could wait a switch interval
            # for the drain thread to give it back
            lib = ctypes.PyDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ssq_seed_chain.argtypes = (
                [vp, vp, ci, ci, ci] * 2 + [ci, vp, vp, vp]
                + [ci] * 10 + [vp, vp, vp])
            lib.ssq_seed_chain.restype = ci
            lib.ssq_seed_chain_smem.argtypes = [ci, ci]
            lib.ssq_seed_chain_smem.restype = ci
            _lib = lib
    return _lib


def n_anchors(L: int, k: int, stride: int) -> int:
    """Grid anchors of a padded width L (find_seeds_hash's count)."""
    return max(1, (max(L - k, 0)) // stride + 1)


def _check(ends, k, max_hits, max_scan, n_chains):
    if not 1 <= len(ends) <= 2:
        raise ValueError(f"one or two ends, got {len(ends)}")
    dev = ends[0][0].device
    for reads, lengths in ends:
        if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
            raise ValueError(f"reads (B, L) and lengths (B,) expected, got "
                             f"{tuple(reads.shape)} and "
                             f"{tuple(lengths.shape)}")
        if reads.device != dev or lengths.device != dev:
            raise ValueError("the ends must share one device")
        if not 16 < k <= 24 or reads.shape[1] < k:
            raise ValueError(f"need 16 < k <= 24 and read width >= k "
                             f"(k={k}, L={reads.shape[1]})")
    if not 1 <= max_hits <= max_scan:
        raise ValueError(f"need 1 <= max_hits <= max_scan (max_hits="
                         f"{max_hits}, max_scan={max_scan})")
    if n_chains < 1:
        raise ValueError(f"need n_chains >= 1, got {n_chains}")
    return dev


def seed_chain(kidx: KmerIndex, ends: Sequence[Tuple[torch.Tensor,
                                                      torch.Tensor]],
               k: int = 19, stride: int = 8, max_hits: int = 4,
               n_chains: int = 4, max_scan: int = 8, max_occ: int = 500,
               band: int = 100) -> List[End]:
    """Per end (reads (B, L) codes, 4 = N/pad; lengths (B,)): (Chains,
    pos, rend_pos), all (B, n_chains), on the reads' device (see the module
    note).  On cuda both ends go through one launch and each end's outputs
    are views of one buffer."""
    dev = _check(ends, k, max_hits, max_scan, n_chains)
    if dev.type == "cpu":
        return [seed_chain_plain(kidx, r, ln, k, stride, max_hits, n_chains,
                                 max_scan, max_occ, band) for r, ln in ends]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if max_scan > MAX_SCAN:
        raise ValueError(f"max_scan {max_scan} above the kernel's "
                         f"{MAX_SCAN} (one lane a bucket entry)")
    i32 = torch.int32
    u8 = all(r.dtype is torch.uint8 for r, _ in ends)
    ends = [(r if (r.dtype is (torch.uint8 if u8 else i32))
             and r.is_contiguous() else r.to(i32).contiguous(),
             ln if ln.dtype is i32 and ln.is_contiguous()
             else ln.to(i32).contiguous()) for r, ln in ends]
    G = [n_anchors(r.shape[1], k, stride) for r, _ in ends]
    lib = _lib or _load()
    S, L = 2 * max(G) * max_hits, max(r.shape[1] for r, _ in ends)
    if lib.ssq_seed_chain_smem(S, L) > SMEM_LIMIT:
        raise ValueError(f"{S} seeds a read at width {L}: more than a "
                         f"block's shared memory holds")
    Bs = [r.shape[0] for r, _ in ends]
    N, K = sum(Bs), n_chains
    out = torch.empty((len(FIELDS), N, K), dtype=i32, device=dev)
    valid = torch.empty((N, K), dtype=torch.bool, device=dev)
    if N:
        (r1, l1), (r2, l2) = ends[0], ends[-1]
        two = len(ends) == 2
        args = (r1.data_ptr(), l1.data_ptr(), Bs[0], r1.shape[1], G[0],
                r2.data_ptr() if two else None,
                l2.data_ptr() if two else None, Bs[1] if two else 0,
                r2.shape[1], G[-1], int(u8), kidx.bucket_start.data_ptr(),
                kidx.positions.data_ptr(), kidx.fp.data_ptr(),
                kidx.positions.shape[0], kidx.bits, k, stride, max_hits,
                max_scan, 1 << (max_scan - 1).bit_length(), max_occ, K,
                band, out.data_ptr(), valid.data_ptr())
        idx = dev.index
        if idx == torch._C._cuda_getDevice():
            rc = lib.ssq_seed_chain(*args,
                                    torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(dev):   # the runtime launches on its device
                rc = lib.ssq_seed_chain(
                    *args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"seed_chain launch failed: cudaError {rc}")
        LAUNCHES["seed_chain"] += 1
        metrics.add("align.seed_chain.kernel_reads", N)
    res = []
    for o, v in zip(out.split(Bs, 1), valid.split(Bs)):
        f = o.unbind(0)
        res.append((Chains(*f[:5], v, *f[5:7]), f[7], f[8]))
    return res


def seed_chain_plain(kidx: KmerIndex, reads, lengths, k: int = 19,
                     stride: int = 8, max_hits: int = 4, n_chains: int = 4,
                     max_scan: int = 8, max_occ: int = 500,
                     band: int = 100) -> End:
    """Plain PyTorch twin of the kernel for one end (any device): hash
    seeds, NMS chains, and the chains' pos and rend_pos."""
    seeds = find_seeds_hash(kidx, reads, lengths, k=k, stride=stride,
                            max_hits=max_hits, max_scan=max_scan,
                            max_occ=max_occ)
    ch = chain_seeds_nms(seeds, reads.shape[1], k=n_chains, band=band)
    diag = ch.anchor_rpos - ch.anchor_qpos
    return ch, diag + ch.qspan_beg, diag + ch.qspan_end
