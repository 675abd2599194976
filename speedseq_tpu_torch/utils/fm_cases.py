"""Seeded edge-case inputs for the FM (SMEM) search kernel ``fm_smem``.

Shared by the CPU tests (the plain twin against the JAX package's
``find_seeds``) and the card tests (the kernel against the twin).  Two
genomes, made from a seed:

- ``random``: random contigs;
- ``tandem``: tandem repeats between random stretches (a 180 bp unit 24
  times at 0.5 % divergence, (CA)n, (AAT)n, 60 bp poly-A and poly-T
  runs), so that a read's interval stays large, and spans occ blocks, for
  many steps, and the T-rich rows at the end of the BWT are reached.

Both have 2 * l_pac ≡ 90 (mod 128): the last occ block is partial, with
rows past its half-way point.  A third genome, ``last_rank_genome``, is
the walk's case of a whole last block with the sentinel rank last
(primary == seq_len): the LF walk's records have no block past it.  Reads cycle through these kinds (the FMD
text is the genome followed by its reverse complement; its start and end
are the rows around ``primary``, the sentinel row):

  exact forward window, exact reverse-strand window, 1 % substitutions,
  a random head then the text's start (the interval holds the sentinel row
  in the backward phase), the text's end then a random tail (the same in
  the forward phase, through the mirror interval), Ns (at 0, at the last
  position and inside), a short read (1-30 bases; the bases past its
  length are random and must read as N), a low-complexity read (poly-A,
  poly-T and (CA)n runs), a random read, a window ending at a contig's
  last base.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .synth import SynthGenome

WIDTHS = (101, 151, 251)
N_KINDS = 10


def _mutate(rng, seq, frac):
    out = seq.copy()
    at = rng.random(len(out)) < frac
    out[at] = (out[at] + rng.integers(1, 4, int(at.sum()))) % 4
    return out


def edge_genomes(seed: int = 0) -> Dict[str, SynthGenome]:
    """{"random", "tandem"}: two-contig genomes of l_pac ≡ 45 (mod 64)."""
    rng = np.random.default_rng(seed)
    rand = lambda n: rng.integers(0, 4, n).astype(np.uint8)
    unit = rand(180)
    tandem0 = np.concatenate(
        [rand(700)] + [_mutate(rng, unit, 0.005) for _ in range(24)]
        + [rand(500), np.tile(np.array([1, 0], np.uint8), 150), rand(400),
           np.full(60, 0, np.uint8), rand(300),
           np.tile(np.array([0, 0, 3], np.uint8), 80), rand(600)])
    tandem1 = np.concatenate([rand(900), np.full(60, 3, np.uint8),
                              rand(700), unit, rand(500 + 45)])
    out = {}
    for name, contigs in (("random", [rand(5000), rand(3045)]),
                          ("tandem", [tandem0, tandem1])):
        pad = (45 - sum(len(c) for c in contigs)) % 64
        contigs[-1] = np.concatenate([contigs[-1], rand(pad)])
        out[name] = SynthGenome(names=["c0", "c1"], contigs=contigs,
                                deletions=[], duplication=(0, 0, 0))
    return out


def last_rank_genome(seed: int = 0, l_pac: int = 4096,
                     head: int = 24) -> SynthGenome:
    """One contig of l_pac ≡ 0 (mod 64) bases (2 * l_pac, seq_len, a whole
    number of 128-row occ blocks) that starts with ``head`` Ts and holds no
    other run of ``head`` As or Ts: the text (genome + reverse complement)
    is then its own largest suffix, so the sentinel rank, primary, is
    seq_len."""
    assert l_pac % 64 == 0
    rng = np.random.default_rng(seed)
    while True:
        rest = rng.integers(0, 4, l_pac - head).astype(np.uint8)
        edges = np.flatnonzero(np.diff(rest.astype(np.int16)) != 0)
        runs = np.diff(np.r_[-1, edges, len(rest) - 1])
        if runs.max() < head:
            break
    contig = np.concatenate([np.full(head, 3, np.uint8), rest])
    return SynthGenome(names=["c0"], contigs=[contig], deletions=[],
                       duplication=(0, 0, 0))


def fmd_text(pac: np.ndarray) -> np.ndarray:
    """The text an FMD index is built over: forward + reverse complement."""
    pac = np.asarray(pac, np.uint8)
    return np.concatenate([pac, 3 - pac[::-1]])


def edge_reads(genome: SynthGenome, L: int, n: int, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(reads (n, L) uint8 codes, 4 = N/pad; lengths (n,) int32)."""
    rng = np.random.default_rng(seed)
    pac = np.concatenate(genome.contigs).astype(np.uint8)
    text = fmd_text(pac)
    rand = lambda m: rng.integers(0, 4, m).astype(np.uint8)
    reads = np.full((n, L), 4, np.uint8)
    lens = np.full(n, L, np.int32)
    for i in range(n):
        kind = i % N_KINDS
        at = int(rng.integers(0, len(pac) - L))
        win = pac[at:at + L]
        if kind == 0:
            r = win
        elif kind == 1:
            r = 3 - win[::-1]
        elif kind == 2:
            r = _mutate(rng, win, 0.01)
        elif kind == 3:
            m = int(rng.integers(8, L - 8))
            r = np.concatenate([rand(L - m), text[:m]])
        elif kind == 4:
            m = int(rng.integers(8, L - 8))
            r = np.concatenate([text[len(text) - m:], rand(L - m)])
        elif kind == 5:
            r = win.copy()
            r[[0, L - 1]] = 4
            r[rng.integers(1, L - 1, 3)] = 4
        elif kind == 6:
            lens[i] = int(rng.integers(1, 31))
            r = win.copy()
            r[lens[i]:] = rand(L - lens[i])
        elif kind == 7:
            runs = [np.full(int(rng.integers(30, 90)), b, np.uint8)
                    for b in (3, 0)]
            r = np.concatenate(runs + [np.tile(np.array([1, 0], np.uint8),
                                               L)])[:L]
        elif kind == 8:
            r = rand(L)
        else:
            end = len(genome.contigs[0]) if i % 2 else len(pac)
            lens[i] = int(rng.integers(L // 2, L + 1))
            r = np.full(L, 4, np.uint8)
            r[:lens[i]] = pac[end - lens[i]:end]
        reads[i] = r
    return reads, lens
