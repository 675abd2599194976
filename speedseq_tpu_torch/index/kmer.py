"""Direct-address k-mer seed index (the hash seeding path), in PyTorch.

Counterpart of speedseq_tpu/index/kmer.py.  The index is built on the host
with numpy exactly as there and handed to the device as tensors:

  bucket_start: (2^bits + 1,) int32  — prefix offsets per hash bucket
  positions:    (n_pos,) int32       — genome positions sorted by bucket
  fp:           (n_pos,) int32       — per-entry 16-bit key fingerprint

A query computes every anchor's k-mer key with exact integer shift-adds
(int64), hashes it with uint32 arithmetic emulated in int64
(``& 0xFFFFFFFF``), gathers the bucket's first ``max_scan`` candidates,
verifies fingerprints and keeps the first ``max_hits`` verified ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

MULT_LO = np.uint32(0x9E3779B1)  # bucket hash multipliers (Fibonacci)
MULT_HI = np.uint32(0x85EBCA6B)
FP_LO = np.uint32(0xC2B2AE35)    # decorrelated fingerprint multipliers
FP_HI = np.uint32(0x27D4EB2F)
_M32 = 0xFFFFFFFF


class KmerIndex(NamedTuple):
    bucket_start: torch.Tensor  # (2^bits + 1,) int32
    positions: torch.Tensor     # (n_pos_pad,) int32
    fp: torch.Tensor            # (n_pos_pad,) int32 holding uint16 values
    l_pac: int
    k: int
    bits: int


def _rolling_keys_np(pac: np.ndarray, k: int):
    n_pos = max(0, len(pac) - k + 1)
    lo = np.zeros(n_pos, dtype=np.uint32)
    hi = np.zeros(n_pos, dtype=np.uint32)
    base = pac.astype(np.uint32)
    for j in range(k):
        b = base[j : j + n_pos]
        hi = (hi << np.uint32(2)) | (lo >> np.uint32(30))
        lo = (lo << np.uint32(2)) | b
    return lo, hi


def kmer_arrays_np(pac: np.ndarray, k: int = 19, bits: int = 0):
    """Host build from 0-3 base codes (one pass + one sort): returns
    (bucket_start int32, positions int32, fp uint16, bits).
    bits=0 → auto (≈2× buckets per position)."""
    pac = np.asarray(pac, dtype=np.uint8)
    n_pos = max(0, len(pac) - k + 1)
    if bits <= 0:
        bits = max(8, min(26, int(np.ceil(np.log2(max(n_pos, 2) * 2)))))
    lo, hi = _rolling_keys_np(pac, k)
    bucket = (((lo * MULT_LO) ^ (hi * MULT_HI)) >> np.uint32(32 - bits)).astype(np.int64)
    fp_all = (((lo * FP_LO) ^ (hi * FP_HI)) >> np.uint32(16)).astype(np.uint16)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=(1 << bits)).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    positions = order.astype(np.int32)
    fp = fp_all[order]
    if len(positions) == 0:
        positions = np.zeros(1, np.int32)
        fp = np.zeros(1, np.uint16)
    return starts, positions, fp, bits


def kmer_index_from_arrays(starts, positions, fp, l_pac: int, k: int,
                           bits: int, device) -> KmerIndex:
    """KmerIndex tensors on ``device`` from numpy index arrays."""
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.int32))).to(dev)
    return KmerIndex(
        bucket_start=as_t(starts), positions=as_t(positions), fp=as_t(fp),
        l_pac=int(l_pac), k=int(k), bits=int(bits),
    )


def build_kmer_index(pac: np.ndarray, k: int = 19, bits: int = 0,
                     device="cpu") -> KmerIndex:
    """Build on the host with numpy, return tensors on ``device``."""
    starts, positions, fp, bits = kmer_arrays_np(pac, k, bits)
    return kmer_index_from_arrays(starts, positions, fp, len(pac), k, bits,
                                  device)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for 0 <= a, c < 2^32 in int64 without overflow:
    split a into 16-bit halves so no partial product exceeds 2^48."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return ((hi << 16) + lo) & _M32


def select_key(ok: torch.Tensor) -> torch.Tensor:
    """Top-k key over the (..., max_scan) candidate columns: verified
    candidates first, then bucket order.  Keys are distinct within a row
    (−j differs per column and ok adds 256 > max_scan), so top-k has no
    ties to break and both frameworks pick the same columns."""
    j = torch.arange(ok.shape[-1], dtype=torch.int32, device=ok.device)
    return (ok.to(torch.int32) << 8) - j


def read_kmers(reads: torch.Tensor, k: int):
    """(lo, hi, bad) at every read position (B, L): the k-mer starting
    there as the key layout of ``_rolling_keys_np`` (hi = the first k - 16
    bases in its low 2(k - 16) bits, lo = the last 16 bases), both as
    int64 tensors holding uint32 values; ``bad`` flags windows holding a
    code above 3 and positions past L - k (their keys are 0).  Built with
    int64 shifts, exact on every device (a float32 convolution would go
    through cuDNN in TF32 on the card).  17 <= k <= 24."""
    if not 16 < k <= 24:
        raise ValueError(f"read_kmers supports 17..24-mers, got k={k}")
    B, L = reads.shape
    dev = reads.device
    r = reads.to(torch.int64).clamp(0, 4)
    bad_ind = (r > 3).to(torch.int64)
    rr = torch.where(r > 3, 0, r)
    n_pos = max(L - k + 1, 0)
    key = torch.zeros((B, n_pos), dtype=torch.int64, device=dev)
    for j in range(k):
        key = (key << 2) | rr[:, j:j + n_pos]
    cs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                    bad_ind.cumsum(1)], dim=1)
    bad = (cs[:, k:k + n_pos] - cs[:, :n_pos]) > 0
    pad = L - n_pos
    lo = Fn.pad(key & 0xFFFFFFFF, (0, pad))
    hi = Fn.pad(key >> 32, (0, pad))
    bad = Fn.pad(bad, (0, pad), value=True)
    return lo, hi, bad


def find_seeds_hash(
    kidx: KmerIndex,
    reads: torch.Tensor,     # (B, L) int codes, 4 = N/pad
    lengths: torch.Tensor,   # (B,) int32
    k: int = 19,
    stride: int = 8,
    max_hits: int = 4,
    max_scan: int = 8,       # bucket entries examined per anchor
    max_occ: int = 500,      # skip ultra-repetitive anchors (bwa -c analog)
):
    """Hash-bucket seeding over grid anchors, both strands.

    Returns a Seeds tuple (align.seeding.Seeds) with
    S = 2 * n_anchors * max_hits; qpos of reverse-strand seeds is in the
    reverse-complemented read frame."""
    from ..align.seeding import Seeds
    from ..align.core import revcomp_reads

    B, L = reads.shape
    if not 16 < k <= 24 or L < k:
        raise ValueError(f"need 16 < k <= 24 and read width >= k (k={k}, L={L})")
    dev = reads.device
    reads = reads.to(torch.int32)
    lengths = lengths.to(torch.int32)
    n_anchor = max(1, (max(L - k, 0)) // stride + 1)
    anchors = torch.minimum(
        torch.arange(n_anchor, dtype=torch.int32, device=dev) * stride,
        torch.tensor(max(L - k, 0), dtype=torch.int32, device=dev))
    G = n_anchor
    reads_rc = revcomp_reads(reads, lengths)
    t2 = k - 16
    win = anchors.long()[:, None] + torch.arange(k, device=dev)[None, :]
    shift = 32 - kidx.bits
    n_entries = kidx.positions.shape[0]

    def anchor_keys(rd):
        r = rd.clamp(0, 4).long()
        w = r[:, win]                                # (B, G, k)
        bad = (w > 3).any(-1)
        w = torch.where(w > 3, 0, w)
        hi = torch.zeros((B, G), dtype=torch.int64, device=dev)
        lo = torch.zeros_like(hi)
        for j in range(t2):          # hi word: first k-16 bases
            hi = (hi << 2) | w[..., j]
        for j in range(t2, k):       # lo word: last 16 bases
            lo = (lo << 2) | w[..., j]
        return lo, hi, bad

    def one_strand(rd):
        a_lo, a_hi, bad = anchor_keys(rd)
        anchor_ok = ~bad & ((anchors[None, :] + k) <= lengths[:, None])
        h = _mul32(a_lo, int(MULT_LO)) ^ _mul32(a_hi, int(MULT_HI))
        f = _mul32(a_lo, int(FP_LO)) ^ _mul32(a_hi, int(FP_HI))
        bkt = h >> shift
        q_fp = f >> 16
        start = kidx.bucket_start[bkt].long()
        n_in_bucket = kidx.bucket_start[bkt + 1].long() - start
        anchor_ok = anchor_ok & (n_in_bucket <= max_occ)
        j = torch.arange(max_scan, dtype=torch.int64, device=dev)
        cand_idx = (start[..., None] + j).clamp(0, n_entries - 1)
        cand_live = anchor_ok[..., None] & (j < n_in_bucket[..., None])
        cand_pos = kidx.positions[cand_idx]
        cand_fp = kidx.fp[cand_idx]
        ok = cand_live & (cand_fp == q_fp[..., None])
        top = torch.topk(select_key(ok), max_hits, dim=-1).indices
        hit_ok = torch.gather(ok, -1, top)
        hit_pos = torch.where(hit_ok, torch.gather(cand_pos, -1, top), -1)
        n_ok = ok.sum(-1).to(torch.int32)
        return hit_pos.to(torch.int32), hit_ok, n_ok

    def pack(hit_pos, hit_ok, n_ok, strand):
        S = G * max_hits
        qp = anchors[None, :, None].expand(B, G, max_hits)
        iv = n_ok[..., None].expand(B, G, max_hits)
        return (
            hit_pos.reshape(B, S),
            qp.reshape(B, S),
            torch.full((B, S), k, dtype=torch.int32, device=dev),
            torch.full((B, S), strand, dtype=torch.int32, device=dev),
            iv.reshape(B, S),
            hit_ok.reshape(B, S),
        )

    f = pack(*one_strand(reads), 0)
    r = pack(*one_strand(reads_rc), 1)
    cat = lambda a, b: torch.cat([a, b], dim=1)
    return Seeds(
        rpos=cat(f[0], r[0]),
        qpos=cat(f[1], r[1]),
        length=cat(f[2], r[2]),
        strand=cat(f[3], r[3]),
        interval_size=cat(f[4], r[4]),
        valid=cat(f[5], r[5]),
    )


def index_from_numpy(pac: np.ndarray, names, lengths, offsets,
                     device="cpu", k: int = 19, bits: int = 0,
                     kmer_arrays: Optional[tuple] = None):
    """The port's whole index state from the reference's numpy arrays:
    (FMIndex with ref_pack/l_pac, KmerIndex).  ``kmer_arrays`` =
    (bucket_start, positions, fp, bits) reuses arrays built elsewhere (the
    tests hand over the JAX package's) instead of rebuilding them."""
    from .fm import FMIndex

    pac = np.asarray(pac, dtype=np.uint8)
    if len(names) != len(lengths) or len(offsets) != len(lengths):
        raise ValueError("names, lengths and offsets must align")
    fm = FMIndex.from_pac(pac, device)
    if kmer_arrays is None:
        kmer_arrays = kmer_arrays_np(pac, k, bits)
    starts, positions, fp, bits = kmer_arrays
    kidx = kmer_index_from_arrays(starts, positions, fp, len(pac), k, bits,
                                  device)
    return fm, kidx
