"""Seeded genomes and reads for the seed_chain kernel's tests.

``genome("random")`` is uniform random bases.  ``genome("repeats")`` lays
over that an Alu-like family (a 300 bp element, ~2 copies a kbp at 0.5 %
divergence: buckets of hundreds of entries), a family of 40 copies
(buckets longer than ``max_scan``), and STR runs of 2 and 3 bp motifs
(buckets past ``max_occ``).  ``reads`` draws reads from either strand with 1 %
substitutions, then makes the awkward rows: lengths below the padded
width and below k (zero included), N bases, and reads all N (from three
reads on, the last is all N and the one before shorter than 17).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def genome(kind: str, n: int = 200_000, seed: int = 0) -> np.ndarray:
    """uint8 codes 0-3 of length n."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    if kind == "random":
        return g
    if kind != "repeats":
        raise ValueError(f"unknown genome kind {kind!r}")

    def lay(unit, copies, div):
        for at in rng.integers(0, n - len(unit), copies):
            c = unit.copy()
            hit = rng.random(len(c)) < div
            c[hit] = (c[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
            g[at:at + len(c)] = c

    lay(rng.integers(0, 4, 1_500).astype(np.uint8), 40, 0.01)
    lay(rng.integers(0, 4, 300).astype(np.uint8), n // 500, 0.005)
    for motif in ((0, 1), (2, 3, 3), (0, 0, 3)):
        lay(np.resize(np.array(motif, np.uint8), 600), 6, 0.0)
    return g


def reads(g: np.ndarray, B: int, L: int, seed: int = 0,
          read_len: int = 150) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 (B, L) codes padded with 4, int32 (B,) lengths)."""
    rng = np.random.default_rng(seed)
    rl = min(read_len, L)
    at = rng.integers(0, len(g) - rl, B)
    seq = g[at[:, None] + np.arange(rl)[None, :]]
    rev = rng.random(B) < 0.5
    seq[rev] = 3 - seq[rev, ::-1]
    err = rng.random(seq.shape) < 0.01
    seq[err] = (seq[err] + rng.integers(1, 4, int(err.sum()))) % 4
    out = np.full((B, L), 4, np.uint8)
    out[:, :rl] = seq
    lengths = np.full(B, rl, np.int32)
    short = rng.random(B) < 0.125
    lengths[short] = rng.integers(0, rl + 1, int(short.sum()))
    for b in np.nonzero(rng.random(B) < 0.2)[0]:
        out[b, rng.integers(0, rl, rng.integers(1, 4))] = 4
    out[rng.random(B) < 0.02] = 4
    if B >= 3:                    # one read all N, one shorter than any k
        out[-1] = 4
        lengths[-2] = rng.integers(0, 17)
    out[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return out, lengths
