"""Seeded inputs for var's two device programs, shared by the CPU tests
(port vs the JAX package) and the card tests (cuda vs cpu).

- ``hap_scan_lanes``: haplotype-scan shapes (reads of 150, windows of
  192 = 150 + 2 × 16 rounded up to 64) from the banded kernels' edge
  cases (N bases, qlen < Lq, qlen = 0, equal placements, long gaps) plus
  two-letter random lanes, where equal row maxima are common.
- ``unbanded_lanes``: the same kinds at any Lq <= Lr (reads of 250 against
  windows of 320 among them), plus codes -1, 4 and 5 in query and window,
  qlen 0, 1 and Lq, and deletions longer than the Pallas kernels' 64-column
  cap that the unbanded DP must take;
- ``cigar_lanes``: ``unbanded_lanes`` plus the traceback DP's own corners
  (an all-zero lane, deletions of 130..200 columns between two short
  halves, insertion runs of 8..20 bases, lanes of more than 48 ops when
  gaps are cheap) at Lq <= Lr <= 256;
- ``cigar_run_lanes``: the traceback walk's long runs at any Lq and
  Lr <= 256: exact placements (diagonal runs of more than 32 rows), a few
  spaced mismatches, and long insertions (I-runs that mode 1 carries);
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


def unbanded_lanes(Lq: int, Lr: int, seed: int, n_edge: int = 52):
    """(query, qlen, ref) int32 numpy arrays for the unbanded scan at
    Lq <= Lr: ``n_edge`` edge-case lanes, 16 two-letter lanes (ties), 16
    lanes of random codes in -1..5 with qlen -1..Lq + 1 (0, 1 and Lq among
    them), and, where the window has room, up to 12 lanes of an exact
    placement with 65..120 bases deleted from its middle (at bwa scoring
    the joined halves outscore either alone where Lq / 2 > o + d e, and the
    deletion state then decides the best cell)."""
    q, ql, r = sw_edge_cases(n_edge, Lq, Lr, seed=seed)
    rng = np.random.default_rng(seed + 7)
    q2 = rng.integers(0, 2, (16, Lq)).astype(np.int32)
    r2 = rng.integers(0, 2, (16, Lr)).astype(np.int32)
    ql2 = rng.integers(0, Lq + 1, 16).astype(np.int32)
    q3 = rng.integers(-1, 6, (16, Lq)).astype(np.int32)
    r3 = rng.integers(-1, 6, (16, Lr)).astype(np.int32)
    ql3 = rng.integers(-1, Lq + 2, 16).astype(np.int32)
    ql3[:3] = (0, 1, Lq)
    r3[3, :Lq] = q3[3]                   # equal codes, negative ones too
    parts = [(q, ql, r), (q2, ql2, r2), (q3, ql3, r3)]
    cut = Lq // 2
    dels = [d for d in range(65, 121, 5) if Lq + d <= Lr - 4]
    if dels:
        r4 = rng.integers(0, 4, (len(dels), Lr)).astype(np.int32)
        q4 = np.stack([np.concatenate([r4[k, 2:2 + cut],
                                       r4[k, 2 + cut + d:2 + Lq + d]])
                       for k, d in enumerate(dels)]).astype(np.int32)
        parts.append((q4, np.full(len(dels), Lq, np.int32), r4))
    return tuple(np.concatenate(a) for a in zip(*parts))


def cigar_lanes(Lq: int, Lr: int, seed: int):
    """(query, qlen, ref) int32 numpy arrays for the traceback DP
    (``ops/sw_unbanded.py:sw_cigar_unbanded``) at Lq <= Lr <= 256:
    ``unbanded_lanes``, then an all-N read, a read that mismatches its
    window everywhere (both all-zero lanes), 8 lanes of two 24-base halves
    of an exact placement around 130..200 deleted window bases (the
    deletion pays at a gap extension of 0), 8 lanes of an exact placement
    with 8..20 inserted bases at its middle (an I-run), and 8 lanes of 2-bp
    indels every 4 bases (more than 48 ops at open 1, extension 1)."""
    q, ql, r = unbanded_lanes(Lq, Lr, seed=seed)
    rng = np.random.default_rng(seed + 11)
    n = 26
    q2 = np.full((n, Lq), 4, np.int32)
    ql2 = np.full(n, Lq, np.int32)
    r2 = rng.integers(0, 4, (n, Lr)).astype(np.int32)
    q2[1] = (r2[1, :Lq] + 1) % 4                   # mismatches everywhere
    for k, d in enumerate(np.linspace(130, 200, 8).astype(int)):
        h = min(24, (Lr - 4 - d) // 2, Lq // 2)
        if h < 8:
            continue
        row = r2[2 + k]
        a = np.concatenate([row[2:2 + h], row[2 + h + d:2 + 2 * h + d]])
        q2[2 + k, :len(a)] = a
        ql2[2 + k] = len(a)
    for k, m in enumerate(range(8, 24, 2)):
        row = r2[10 + k]
        h = (Lq - m) // 2
        a = np.concatenate([row[4:4 + h], rng.integers(0, 4, m),
                            row[4 + h:4 + Lq - m]])[:Lq]
        q2[10 + k, :len(a)] = a
        ql2[10 + k] = len(a)
    for k in range(8):
        row, parts, j, ins = r2[18 + k], [], 2 + k, k % 2 == 0
        while sum(len(p) for p in parts) < Lq and j + 6 < Lr:
            parts.append(row[j:j + 4])
            j += 4
            if ins:
                parts.append(rng.integers(0, 4, 2))
            else:
                j += 2
            ins = not ins
        a = np.concatenate(parts)[:Lq]
        q2[18 + k, :len(a)] = a
        ql2[18 + k] = len(a)
    return (np.concatenate([q, q2]), np.concatenate([ql, ql2]),
            np.concatenate([r, r2]))


def cigar_run_lanes(Lq: int, Lr: int, seed: int):
    """(query, qlen, ref) int32 numpy arrays of 13 lanes for the traceback
    DP at any Lq >= 1 and Lr <= 256: an exact copy of the window's first
    min(Lq, Lr - 2) bases; the same behind Lq - that many random bases
    (qlen Lq); exact copies with 1, 2 and 3 mismatches 40 bases apart;
    an exact copy of the window reversed against it (no run); where the
    window has room, exact placements with 6, 12, 24, 40, 60 and 90
    random bases inserted at their middle (at a gap extension of 1 and
    open 1 the insertion is one I-run, its steps past the first forced by
    mode 1); and the window's last min(Lq - 1, Lr) // 2 bases then one
    base that mismatches the window's last (the last row's maximum one
    column short of the diagonal's exit past the window)."""
    rng = np.random.default_rng(seed)
    n = 13
    q = rng.integers(0, 4, (n, Lq)).astype(np.int32)
    r = rng.integers(0, 4, (n, Lr)).astype(np.int32)
    ql = np.full(n, Lq, np.int32)
    L = min(Lq, Lr - 2)
    q[0, :L] = r[0, 1:1 + L]
    ql[0] = L
    q[1, Lq - L:] = r[1, 1:1 + L]
    for k, mis in ((2, 1), (3, 2), (4, 3)):
        q[k, :L] = r[k, 1:1 + L]
        at = 20 + 40 * np.arange(mis)
        at = at[at < L]
        q[k, at] = (q[k, at] + 1) % 4
        ql[k] = L
    q[5, :L] = r[5, 1:1 + L][::-1]
    ql[5] = L
    for k, ins in zip(range(6, 12), (6, 12, 24, 40, 60, 90)):
        h = min((Lr - 4) // 2, (Lq - ins) // 2)
        if h < 8:
            continue
        a = np.concatenate([r[k, 2:2 + h], rng.integers(0, 4, ins),
                            r[k, 2 + h:2 + 2 * h]])
        q[k, :len(a)] = a
        ql[k] = len(a)
    h = min(Lq - 1, Lr) // 2
    q[12, :h] = r[12, Lr - h:]
    q[12, h] = (r[12, Lr - 1] + 1) % 4
    ql[12] = h + 1
    return q, ql, r


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
