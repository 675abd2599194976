"""Seed table shared by the seeding paths, and FM (SMEM) seeding.

Counterpart of speedseq_tpu/align/seeding.py.  ``find_seeds`` anchors at a
fixed grid of read positions and takes, per anchor p, the maximal exact
match through p with the longest right extension (forward FMD extension
to e(p), then backward extension from e(p) to s(p)): [s(p), e(p)) is an
SMEM.  The two extension loops run in the hand kernel ``fm_smem``
(``ops/fm_search.py``), SA lookups where the index has no full SA in
``fm_sa_walk``; dedup, filtering, hit expansion and strand correction are
tensor code over fixed (B, G) shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..index.fm import FMIndex
from ..ops.fm_search import SmemLanes, fm_sa_walk, fm_smem


class Seeds(NamedTuple):
    """Per-read seed table, fixed shape (B, S).

    Coordinates are strand-corrected: for reverse-strand hits qpos/rpos
    refer to the reverse-complemented read against the forward genome.
    """

    rpos: torch.Tensor    # (B, S) int32 genome pos of seed start (fwd strand)
    qpos: torch.Tensor    # (B, S) int32 read pos of seed start (strand frame)
    length: torch.Tensor  # (B, S) int32 seed length
    strand: torch.Tensor  # (B, S) int32 0=fwd 1=rev
    interval_size: torch.Tensor  # (B, S) int32 occurrence count
    valid: torch.Tensor   # (B, S) bool


def grid(read_len: int, stride: int, device) -> torch.Tensor:
    """Anchor positions over the padded read width (G,) int32."""
    n = max(1, (read_len + stride - 1) // stride)
    return (torch.arange(n, dtype=torch.int32, device=device) * stride
            ).clamp_max(read_len - 1)


def sa_lookup(fm: FMIndex, r: torch.Tensor) -> torch.Tensor:
    """SA value (position in the 2·l_pac FMD text) of rank r: one gather
    of the full SA where the index keeps it, else the LF walk
    (``fm_sa_walk``)."""
    if fm.sa_dense is not None:
        return fm.sa_dense[r.to(torch.int64).clamp(0, fm.seq_len)]
    return fm_sa_walk(fm, r)


def hit_ranks(lanes: SmemLanes, B: int, G: int, min_seed_len: int = 19,
              max_occ: int = 500, max_hits: int = 4):
    """The ranks ``find_seeds`` looks up from ``fm_smem``'s lanes of B
    reads x G anchors: up to max_hits SA positions per kept SMEM (unique
    among consecutive anchors, at least min_seed_len long, 1..max_occ
    occurrences), dead hits at rank 1.  Returns (ranks (B, G, max_hits)
    int32, hit_ok (B, G, max_hits) bool)."""
    qbeg = lanes.qbeg.reshape(B, G)
    qend = lanes.qend.reshape(B, G)
    ivk = lanes.k.reshape(B, G)
    ivs = lanes.s.reshape(B, G)
    # dedup identical SMEMs found from consecutive anchors
    uniq = torch.ones((B, G), dtype=torch.bool, device=qbeg.device)
    uniq[:, 1:] = (qbeg[:, 1:] != qbeg[:, :-1]) | (qend[:, 1:] != qend[:, :-1])
    smem_ok = (uniq & (qend - qbeg >= min_seed_len) & (ivs > 0)
               & (ivs <= max_occ) & lanes.alive0.reshape(B, G))
    h = torch.arange(max_hits, dtype=torch.int32, device=qbeg.device)
    hit_ok = smem_ok[..., None] & (h < ivs.clamp_max(max_hits)[..., None])
    return torch.where(hit_ok, ivk[..., None] + h, 1), hit_ok


def find_seeds(fm: FMIndex, reads: torch.Tensor, lengths: torch.Tensor,
               stride: int = 8, min_seed_len: int = 19, max_occ: int = 500,
               max_hits: int = 4) -> Seeds:
    """SMEM seeds of reads (B, L) base codes (4 = N/pad), lengths (B,):
    S = G * max_hits slots per read (bwa mem -k / -c defaults)."""
    B, L = reads.shape
    i32 = torch.int32
    starts = grid(L, stride, reads.device)
    G = starts.shape[0]
    lanes = fm_smem(fm, reads, lengths, starts)
    qbeg = lanes.qbeg.reshape(B, G)
    seed_len = lanes.qend.reshape(B, G) - qbeg
    ivs = lanes.s.reshape(B, G)
    safe_ranks, hit_ok = hit_ranks(lanes, B, G, min_seed_len, max_occ,
                                   max_hits)
    tpos = sa_lookup(fm, safe_ranks.reshape(-1)).reshape(B, G, max_hits)

    slen = seed_len[..., None].expand(B, G, max_hits)
    qb = qbeg[..., None].expand(B, G, max_hits)
    rlen = lengths.to(i32)[:, None, None]
    is_rev = tpos >= fm.l_pac
    rpos_rev = 2 * fm.l_pac - (tpos + slen)
    rpos = torch.where(is_rev, rpos_rev, tpos)
    qpos = torch.where(is_rev, rlen - (qb + slen), qb)
    # discard hits whose text span crosses the fwd/rev junction
    crosses = ((~is_rev & (tpos + slen > fm.l_pac))
               | (is_rev & (rpos < 0)))
    S = G * max_hits
    return Seeds(
        rpos=rpos.reshape(B, S).to(i32),
        qpos=qpos.reshape(B, S).to(i32),
        length=slen.reshape(B, S).to(i32),
        strand=is_rev.reshape(B, S).to(i32),
        interval_size=ivs[..., None].expand(B, G, max_hits).reshape(B, S),
        valid=(hit_ok & ~crosses).reshape(B, S),
    )
