"""Seeded edge-case inputs for the banded Smith-Waterman kernels.

Shared by the CPU tests (twin vs the JAX package's Pallas kernels in
interpret mode) and chip_smoke.py (CUDA kernel vs twin on the card).  Each
lane is one case, cycling through:

  exact match, mismatches, short insertion, short deletion, deletion longer
  than 64, N bases in the query, N bases in the window, qlen < Lq,
  qlen = 0, a tie between two equal placements, many alternating 1-bp
  indels (> 48 cigar ops when gaps are cheap), a query running past the
  window's right edge, and a random query.
"""

from __future__ import annotations

import numpy as np

N_KINDS = 13


def sw_edge_cases(n: int, Lq: int, Lr: int = 256, seed: int = 0):
    """(query (n, Lq), qlen (n,), ref (n, Lr)) int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    query = np.full((n, Lq), 4, np.int32)
    qlen = np.zeros(n, np.int32)
    ref = rng.integers(0, 4, (n, Lr)).astype(np.int32)
    rand = lambda m: rng.integers(0, 4, m).astype(np.int32)
    for lane in range(n):
        kind = lane % N_KINDS
        r = ref[lane]
        off = int(rng.integers(8, 44))
        L = Lq
        # bases of an exact placement the window holds: fewer than L in a
        # narrow window, where picks past them are dropped (the draws stay
        # those of a wide window)
        fit = min(L, Lr - off)
        if kind == 0:                       # exact
            q = r[off:off + L]
        elif kind == 1:                     # mismatches
            q = r[off:off + L].copy()
            at = rng.choice(L, size=max(1, L // 25), replace=False)
            at = at[at < fit]
            q[at] = (q[at] + 1 + rng.integers(0, 3, len(at))) % 4
        elif kind == 2:                     # 3-bp insertion
            cut = L // 2
            q = np.concatenate([r[off:off + cut], rand(3),
                                r[off + cut:off + L]])
        elif kind == 3:                     # 5-bp deletion
            cut = L // 2
            q = np.concatenate([r[off:off + cut], r[off + cut + 5:]])
        elif kind == 4:                     # deletion longer than 64
            cut = L // 3
            q = np.concatenate([r[off:off + cut], r[off + cut + 70:]])
        elif kind == 5:                     # N bases in the query
            q = r[off:off + L].copy()
            at = rng.choice(L, size=4, replace=False)
            q[at[at < fit]] = 4
        elif kind == 6:                     # N bases in the window
            at = rng.choice(L, size=4, replace=False)
            r[off + at[at < fit]] = 4
            q = r[off:off + L]
        elif kind == 7:                     # qlen < Lq
            L = int(rng.integers(L // 3, L - 1))
            q = r[off:off + L]
        elif kind == 8:                     # qlen = 0, junk in the row
            query[lane] = rand(Lq)
            continue
        elif kind == 9:                     # tie: two equal placements
            seg = 40
            r[off + 60:off + 60 + seg] = r[off:off + seg]
            q = np.concatenate([r[off:off + seg], rand(Lq - seg)])
        elif kind == 10:                    # many alternating 1-bp indels
            parts, j, ins = [], off, True
            while sum(len(p) for p in parts) < L:
                parts.append(r[j:j + 3])
                j += 3
                if ins:
                    parts.append(rand(1))
                else:
                    j += 1
                ins = not ins
            q = np.concatenate(parts)
        elif kind == 11:                    # runs past the right edge
            start = Lr - L // 2
            q = np.concatenate([r[start:], rand(L)])
        else:                               # random
            q = rand(L)
        q = np.asarray(q, np.int32)[:L]
        L = min(L, len(q))
        query[lane, :L] = q[:L]
        qlen[lane] = L
    return query, qlen, ref


def sw_cap_cases(n: int, Lq: int, Lr: int = 256, seed: int = 0):
    """Deletions at the deletion window's 64-column cap: lane k deletes
    62 + k % 5 bases (62 .. 66) from the middle of an exact placement, so
    that where the two halves outscore either alone (Lq = 151 with bwa
    scoring) the deletion state F decides the best cell, and at 65 and 66
    bases the cap forbids that one deletion.  Same layout as
    ``sw_edge_cases``."""
    rng = np.random.default_rng(seed)
    query = np.full((n, Lq), 4, np.int32)
    qlen = np.full(n, Lq, np.int32)
    ref = rng.integers(0, 4, (n, Lr)).astype(np.int32)
    cut = Lq // 2
    for lane in range(n):
        d = 62 + lane % 5
        # the second half's band column off + d stays below 128, and its
        # last base inside the window
        hi = max(9, min(128 - d, Lr - Lq - d + 1))
        off = int(rng.integers(8, hi))
        r = ref[lane]
        q = np.concatenate([r[off:off + cut], r[off + cut + d:]])[:Lq]
        query[lane, :len(q)] = q
        qlen[lane] = len(q)
    return query, qlen, ref


LONG_KINDS = 5


def sw_long_run_cases(n: int, Lq: int = 256, Lr: int = 256, seed: int = 0):
    """Long diagonal chains, for the traceback's jumps (at most 127 rows a
    step) and its NM: lane k is kind k % 5 of

      an ungapped chain of 128, 129, 200 or Lq rows (Lq = Lr = 256: the
      whole window) with two mismatches in its first rows (6 and 12), a
      chain of 140 rows then a 2-bp insertion, 20 rows and a 4-bp deletion
      then a chain of 160 rows with a mismatch at its row 8, N bases in
      the query and in the window inside a 180-row chain, and a 150-row
      read equal to its window but at row 5.

    Same layout as ``sw_edge_cases``; the cases need Lq >= 200."""
    rng = np.random.default_rng(seed)
    query = np.full((n, Lq), 4, np.int32)
    qlen = np.zeros(n, np.int32)
    ref = rng.integers(0, 4, (n, Lr)).astype(np.int32)
    rand = lambda m: rng.integers(0, 4, m).astype(np.int32)
    flip = lambda b: (b + 1 + rng.integers(0, 3)) % 4
    for lane in range(n):
        kind = lane % LONG_KINDS
        r = ref[lane]
        if kind == 0:                       # one chain, mismatches at 6, 12
            L = (128, 129, 200, Lq)[(lane // LONG_KINDS) % 4]
            off = int(rng.integers(0, min(Lr - L, 40) + 1))
            q = r[off:off + L].copy()
            q[[6, 12]] = flip(q[[6, 12]])
        elif kind == 1:                     # 140-row chain, 2-bp insertion
            off = int(rng.integers(0, 20))
            q = np.concatenate([r[off:off + 140], rand(2),
                                r[off + 140:off + 190]])
        elif kind == 2:                     # 4-bp deletion, 160-row chain
            off = int(rng.integers(0, 20))
            q = np.concatenate([r[off:off + 20], r[off + 24:off + 184]])
            q[28] = flip(q[28])
        elif kind == 3:                     # N bases inside a 180-row chain
            off = int(rng.integers(0, 40))
            r[off + 100] = 4
            q = r[off:off + 180].copy()
            q[[40, 130]] = 4
        else:                               # 150 bp, one mismatch at row 5
            off = int(rng.integers(0, 60))
            q = r[off:off + 150].copy()
            q[5] = flip(q[5])
        q = np.asarray(q, np.int32)[:Lq]
        query[lane, :len(q)] = q
        qlen[lane] = len(q)
    return query, qlen, ref
