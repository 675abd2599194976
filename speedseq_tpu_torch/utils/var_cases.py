"""Seeded inputs for var's two device programs, shared by the CPU tests
(port vs the JAX package) and the card tests (cuda vs cpu).

- ``hap_scan_lanes``: haplotype-scan shapes (reads of 150, windows of
  192 = 150 + 2 × 16 rounded up to 64) from the banded kernels' edge
  cases (N bases, qlen < Lq, qlen = 0, equal placements, long gaps) plus
  two-letter random lanes, where equal row maxima are common.
- ``random_sites``: random per-site observations, qualities, samples,
  placements and strands with 1..max_alts live alleles per site.
"""

from __future__ import annotations

import numpy as np

from .sw_cases import sw_edge_cases


def hap_scan_lanes(seed: int):
    """(query (170, 150), qlen (170,), ref (170, 192)) int32 numpy
    arrays: 130 edge-case lanes, then 40 two-letter lanes."""
    Lq, Lr = 150, 192
    q, ql, r = sw_edge_cases(130, Lq, Lr, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q2 = rng.integers(0, 2, (40, Lq)).astype(np.int32)
    r2 = rng.integers(0, 2, (40, Lr)).astype(np.int32)
    ql2 = rng.integers(0, Lq + 1, 40).astype(np.int32)
    ql2[:3] = (0, 1, Lq)
    q2[3, :] = 4                                   # an all-N read
    return (np.concatenate([q, q2]), np.concatenate([ql, ql2]),
            np.concatenate([r, r2]))


def random_sites(seed: int, S: int, R: int, n_samples: int,
                 max_alts: int = 3):
    """(obs, quals, sample, rpos, strand, rlen_half, n_alts): the
    per-window-read layout genotype_sites compacts itself."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(-1, 3, (S, R)).astype(np.int8)
    quals = rng.integers(3, 41, (S, R)).astype(np.float32)
    sample = rng.integers(0, n_samples, R).astype(np.int32)
    rpos = np.where(obs >= 0, rng.integers(0, 100, (S, R)), -1
                    ).astype(np.int32)
    strand = rng.integers(0, 2, R).astype(np.int8)
    rlen_half = np.full(R, 50.0, np.float32)
    n_alts = rng.integers(1, max_alts + 1, S).astype(np.int32)
    return obs, quals, sample, rpos, strand, rlen_half, n_alts
