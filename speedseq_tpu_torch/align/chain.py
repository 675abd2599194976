"""Seed chaining (speedseq_tpu/align/chain.py counterpart): the sorting
chainer of the FM path (``chain_seeds``) and the sort-free chainer of
densely tiled hash seeds (``chain_seeds_nms``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .seeding import Seeds


class Chains(NamedTuple):
    """Top-K candidate chains per read; all (B, K)."""

    anchor_rpos: torch.Tensor   # genome pos of the chain's longest seed
    anchor_qpos: torch.Tensor   # read pos (strand frame) of that seed
    anchor_len: torch.Tensor
    strand: torch.Tensor
    weight: torch.Tensor        # chain weight (approx score)
    valid: torch.Tensor         # bool
    qspan_beg: torch.Tensor     # min seed qpos in chain (strand frame)
    qspan_end: torch.Tensor     # max seed qpos+len in chain


def chain_seeds(seeds: Seeds, read_len: int, k: int = 4, band: int = 100,
                max_chain_gap: int = 10000) -> Chains:
    """Diagonal-binned chaining: seeds sorted (stably) by (strand,
    diagonal), invalid ones last; a chain breaks where the strand changes,
    the diagonal jumps by more than ``band`` or the genome position by more
    than ``max_chain_gap``.  Weight = Σ per-seed query-novel bases; anchor
    = longest seed (ties to the last slot in sorted order); the top k
    chains by weight, ties to the lowest chain id (lax.top_k's order)."""
    B, S = seeds.rpos.shape
    dev = seeds.rpos.device
    i32 = torch.int32
    diag = seeds.rpos - seeds.qpos + read_len  # ≥ 0
    key = torch.where(seeds.valid, seeds.strand * (1 << 30) + diag,
                      2 ** 31 - 1)
    order = torch.argsort(key, dim=1, stable=True)
    take = lambda a: torch.gather(a, 1, order)
    rpos, qpos, slen = take(seeds.rpos), take(seeds.qpos), take(seeds.length)
    strand, valid, dg = take(seeds.strand), take(seeds.valid), take(diag)

    prev_same = (
        (strand[:, 1:] == strand[:, :-1])
        & ((dg[:, 1:] - dg[:, :-1]).abs() <= band)
        & ((rpos[:, 1:] - rpos[:, :-1]).abs() <= max_chain_gap)
        & valid[:, 1:] & valid[:, :-1]
    )
    new_chain = torch.cat([torch.ones((B, 1), dtype=i32, device=dev),
                           1 - prev_same.to(i32)], dim=1)
    cid = (torch.cumsum(new_chain, dim=1) - 1).to(torch.int64)

    zeros = torch.zeros((B, S), dtype=i32, device=dev)
    qend_prev = torch.cat([zeros[:, :1], (qpos + slen)[:, :-1]], dim=1)
    novel = torch.where(new_chain == 1, slen,
                        (qpos + slen - torch.maximum(qpos, qend_prev))
                        .clamp_min(0))
    weight = zeros.scatter_add(1, cid, torch.where(valid, novel, 0).to(i32))
    chain_valid = zeros.scatter_add(1, cid, valid.to(i32)) > 0

    # anchor = longest seed in chain (scatter-max on len·4096 + slot)
    slot = torch.arange(S, dtype=i32, device=dev)[None, :]
    packed = torch.where(valid, slen * 4096 + slot, -1).to(i32)
    best = torch.full((B, S), -1, dtype=i32, device=dev).scatter_reduce(
        1, cid, packed, "amax")
    anchor_slot = (best % 4096).clamp(0, S - 1).to(torch.int64)
    gat = lambda a: torch.gather(a, 1, anchor_slot)

    # per-chain query span (split detection without a traceback)
    BIGQ = 1 << 20
    qbeg_c = torch.full((B, S), BIGQ, dtype=i32, device=dev).scatter_reduce(
        1, cid, torch.where(valid, qpos, BIGQ).to(i32), "amin")
    qend_c = zeros.scatter_reduce(
        1, cid, torch.where(valid, qpos + slen, 0).to(i32), "amax")

    # top k by weight; a stable descending sort keeps the lower id first
    w_rank = torch.where(chain_valid, weight, -1)
    topw, topi = torch.sort(w_rank, dim=1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    sel = lambda a: torch.gather(a, 1, topi)
    return Chains(
        anchor_rpos=sel(gat(rpos)).to(i32),
        anchor_qpos=sel(gat(qpos)).to(i32),
        anchor_len=sel(gat(slen)).to(i32),
        strand=sel(gat(strand)).to(i32),
        weight=topw.to(i32),
        valid=topw > 0,
        qspan_beg=sel(qbeg_c).clamp_max(BIGQ - 1).to(i32),
        qspan_end=sel(qend_c).to(i32),
    )


def chain_seeds_nms(seeds: Seeds, read_len: int, k: int = 4,
                    band: int = 100) -> Chains:
    """Sort-free chaining: k rounds of non-max suppression over the (S × S)
    same-strand, near-diagonal mask.  Weight = min(query-span union,
    Σ seed lengths).  Picks: max weight then lowest slot; anchor = longest
    member seed, ties to the lowest slot (argmax returns the first max)."""
    B, S = seeds.rpos.shape
    dev = seeds.rpos.device
    i32 = torch.int32
    diag = seeds.rpos - seeds.qpos + read_len
    slot = torch.arange(S, dtype=i32, device=dev)
    BIGQ = 1 << 20

    same = (
        ((diag[:, :, None] - diag[:, None, :]).abs() <= band)
        & (seeds.strand[:, :, None] == seeds.strand[:, None, :])
    )
    qp = seeds.qpos
    qe = seeds.qpos + seeds.length
    active = seeds.valid
    bidx = torch.arange(B, device=dev)
    outs = []
    for _ in range(k):
        grp = same & active[:, None, :] & active[:, :, None]
        qbeg_i = torch.where(grp, qp[:, None, :], BIGQ).amin(2)
        qend_i = torch.where(grp, qe[:, None, :], 0).amax(2)
        tot_i = torch.where(grp, seeds.length[:, None, :], 0).sum(2).to(i32)
        w_i = torch.where(active, torch.minimum(qend_i - qbeg_i, tot_i), -1)
        pick_key = w_i * (1 << 10) + (S - 1 - slot)[None, :]
        pick_key = torch.where(active, pick_key, -1)
        best = torch.argmax(pick_key, dim=1)
        member = grp[bidx, best]
        apk = torch.where(
            member, seeds.length * (1 << 10) + (S - 1 - slot)[None, :], -1)
        aslot = torch.argmax(apk, dim=1)
        wb = w_i[bidx, best]
        ok = wb > 0
        outs.append((
            torch.where(ok, seeds.rpos[bidx, aslot], -1),
            torch.where(ok, seeds.qpos[bidx, aslot], 0),
            seeds.length[bidx, aslot],
            seeds.strand[bidx, aslot],
            torch.where(ok, wb, 0),
            ok,
            torch.clamp_max(qbeg_i[bidx, best], BIGQ - 1),
            qend_i[bidx, best],
        ))
        active = active & ~member

    stack = lambda i: torch.stack([o[i] for o in outs], dim=1)
    return Chains(
        anchor_rpos=stack(0).to(i32),
        anchor_qpos=stack(1).to(i32),
        anchor_len=stack(2).to(i32),
        strand=stack(3).to(i32),
        weight=stack(4).to(i32),
        valid=stack(5),
        qspan_beg=stack(6).to(i32),
        qspan_end=stack(7).to(i32),
    )
