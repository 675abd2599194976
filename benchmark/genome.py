"""Seeded inputs of the benchmark: the repeat-rich reference genome, the
sample's haplotypes, paired reads and their FASTQ files.

The reference is configuration: one recipe in the configuration's file,
with its own ``reference_seed``, gives the same genome in every run, so
its bwa index is built once per checkout (``benchmark/cache/``).  The
sample's haplotypes come from the configuration's ``sample_seed``, the
reads from the run's ``--seed`` (``sample.py``).

The read simulator follows the port's seeded generators
(``utils/sim.py:simulate_pairs``, ``utils/synth.py:simulate``,
``utils/somatic_cases.py:tumor_normal``): FR pairs, insert N(mean, std)
with fragments shorter than a read drawn again, read 2 the reverse
complement of the fragment's far end, the pair flipped with probability
1/2, and a share of read-2 ends "seed-killed" (every 9th base changed).
In place of the generators' one fixed quality, every base gets a quality
from a binned Illumina profile that falls toward the read's 3' end, and
its substitution error is drawn at that quality.  It draws the same
quantities vectorised, so a run's set-up does not loop over reads in
Python.  Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


class Genome(NamedTuple):
    names: List[str]
    contigs: List[np.ndarray]        # uint8 codes 0-3
    repeat: List[np.ndarray]         # bool mask: base lies in a repeat copy


class Haplotype(NamedTuple):
    seq: np.ndarray                  # uint8 codes
    coord: np.ndarray                # reference position of each base
    variants: List[Tuple[int, str, str]]   # (pos0, ref, alt), VCF style


def recipe_key(recipe: dict) -> str:
    """A short stable hash of a reference recipe (the index cache key)."""
    blob = json.dumps(recipe, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _diverge(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def _revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq[::-1]).astype(np.uint8)


def make_reference(recipe: dict) -> Genome:
    """Random contigs carrying repeat families in the recipe's shares:
    interspersed copies of an Alu-like and an L1-like consensus (L1 copies
    truncated at their 5' end), short tandem repeats, then segmental
    duplications copied from the result (so they carry the interspersed
    copies inside them).  Copies diverge from their source by substitutions
    only; either strand.  ``repeat`` marks every base of every copy, and
    both sides of a duplication."""
    rng = np.random.default_rng(int(recipe["reference_seed"]))
    names = [c[0] for c in recipe["contigs"]]
    lens = np.array([int(c[1]) for c in recipe["contigs"]], np.int64)
    contigs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in lens]
    mask = [np.zeros(int(n), bool) for n in lens]
    total = int(lens.sum())
    p_contig = lens / total

    def place(seq: np.ndarray):
        t = int(rng.choice(len(lens), p=p_contig))
        n = len(seq)
        if n >= lens[t]:
            return
        s = int(rng.integers(0, lens[t] - n))
        contigs[t][s:s + n] = seq
        mask[t][s:s + n] = True

    rep = recipe["repeats"]
    for fam in ("l1", "alu"):
        f = rep[fam]
        cons = rng.integers(0, 4, int(f["consensus_bp"])).astype(np.uint8)
        mean_bp = float(f.get("mean_copy_bp", f["consensus_bp"]))
        n_copies = int(round(f["genome_share"] * total / mean_bp))
        lo, hi = f["divergence"]
        for _ in range(n_copies):
            if mean_bp < len(cons):       # 5'-truncated: keep the 3' end
                n = int(min(len(cons), max(100, rng.exponential(mean_bp))))
                seq = cons[len(cons) - n:]
            else:
                seq = cons
            seq = _diverge(rng, seq, float(rng.uniform(lo, hi)))
            place(_revcomp(seq) if rng.random() < 0.5 else seq)
    f = rep["str"]
    u_lo, u_hi = f["unit_bp"]
    c_lo, c_hi = f["copy_bp"]
    n_copies = int(round(f["genome_share"] * total / ((c_lo + c_hi) / 2)))
    for _ in range(n_copies):
        unit = rng.integers(0, 4, int(rng.integers(u_lo, u_hi + 1)))
        n = int(rng.integers(c_lo, c_hi + 1))
        seq = np.resize(unit, n).astype(np.uint8)
        place(_diverge(rng, seq, float(f["divergence"])))
    f = rep["segdup"]
    b_lo, b_hi = f["copy_bp"]
    i_lo, i_hi = f["identity"]
    target = f["genome_share"] * total
    done = 0
    while done < target:
        n = int(np.exp(rng.uniform(np.log(b_lo), np.log(b_hi))))
        ts = int(rng.choice(len(lens), p=p_contig))
        if n >= lens[ts]:
            continue
        s = int(rng.integers(0, lens[ts] - n))
        seq = _diverge(rng, contigs[ts][s:s + n],
                       1.0 - float(rng.uniform(i_lo, i_hi)))
        mask[ts][s:s + n] = True
        place(_revcomp(seq) if rng.random() < 0.5 else seq)
        done += n
    return Genome(names, contigs, mask)


def write_fasta(path: str, genome: Genome, width: int = 60) -> None:
    with open(path, "wb") as fh:
        for name, codes in zip(genome.names, genome.contigs):
            fh.write(b">" + name.encode() + b"\n")
            s = BASES[codes]
            n = len(s)
            full = n // width * width
            if full:
                body = np.concatenate([s[:full].reshape(-1, width),
                                       np.full((full // width, 1), 10,
                                               np.uint8)], 1)
                fh.write(body.tobytes())
            if n > full:
                fh.write(s[full:].tobytes() + b"\n")


def mutate(ref: np.ndarray, rng, snv_rate: float, indel_rate: float = 0.0,
           max_indel: int = 8) -> Haplotype:
    """One haplotype: at each position an SNV with probability
    ``snv_rate``, else an indel of 1..max_indel bp with ``indel_rate``
    (deletion or insertion, even odds), as ``utils/sim.py:mutate`` draws
    them; positions inside a deletion take no event.  ``coord`` maps each
    haplotype base to its reference position (inserted bases to the base
    before them)."""
    n = len(ref)
    r = rng.random(n)
    ev = np.nonzero(r < snv_rate + indel_rate)[0]
    pieces, coords, variants = [], [], []
    i = 0
    for p in ev:
        p = int(p)
        if p < i:
            continue
        if r[p] < snv_rate:
            b = int(ref[p])
            alt = (b + 1 + int(rng.integers(0, 3))) % 4
            pieces += [ref[i:p], np.array([alt], np.uint8)]
            coords += [np.arange(i, p + 1)]
            variants.append((p, "ACGT"[b], "ACGT"[alt]))
            i = p + 1
            continue
        if not (0 < p < n - max_indel - 1):
            continue
        ln = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:              # delete ln bases after p-1
            ref_allele = BASES[ref[p - 1:p + ln]].tobytes().decode()
            variants.append((p - 1, ref_allele, ref_allele[0]))
            pieces.append(ref[i:p])
            coords.append(np.arange(i, p))
            i = p + ln
        else:                               # insert ln bases after p-1
            ins = rng.integers(0, 4, ln).astype(np.uint8)
            anchor = "ACGT"[int(ref[p - 1])]
            variants.append((p - 1, anchor,
                             anchor + BASES[ins].tobytes().decode()))
            pieces += [ref[i:p], ins]
            coords += [np.arange(i, p), np.full(ln, p - 1)]
            i = p
    pieces.append(ref[i:])
    coords.append(np.arange(i, n))
    return Haplotype(np.concatenate(pieces).astype(np.uint8),
                     np.concatenate(coords).astype(np.int64), variants)


class Reads(NamedTuple):
    seq1: np.ndarray                 # (n, L) uint8 codes
    seq2: np.ndarray
    tid: np.ndarray                  # (n,) contig of origin
    pos1: np.ndarray                 # leftmost reference base of read 1
    pos2: np.ndarray
    rev1: np.ndarray                 # read 1 on the reverse strand
    killed: np.ndarray               # read 2 seed-killed
    unique: np.ndarray               # the whole fragment outside repeats
    qual1: np.ndarray                # (n, L) uint8 phred, in read order
    qual2: np.ndarray


def draw_quals(rng, shape, profile: dict) -> np.ndarray:
    """Phred qualities of ``shape`` (reads, cycles): each base falls in
    one of ``profile["bins"]`` with shares that move linearly from
    ``first_cycle`` to ``last_cycle`` along the read."""
    bins = np.asarray(profile["bins"], np.uint8)
    first = np.asarray(profile["first_cycle"], np.float64)
    last = np.asarray(profile["last_cycle"], np.float64)
    t = np.linspace(0.0, 1.0, shape[1])[:, None]
    cum = np.cumsum(first + (last - first) * t, 1)[:, :-1]     # (L, B-1)
    u = rng.random(shape)
    return bins[(u[..., None] >= cum).sum(-1)]


def simulate_pairs(rng, haps: Sequence[Haplotype], tid: int, n_pairs: int,
                   read_len: int, insert_mean: float, insert_std: float,
                   quality: dict, lo: int = 0, hi: Optional[int] = None,
                   repeat: Optional[np.ndarray] = None,
                   dup_rate: float = 0.0, kill_frac: float = 0.0) -> Reads:
    """``n_pairs`` FR pairs from reference interval [lo, hi) of one
    contig, each fragment from one of ``haps`` with equal odds.  A share
    ``dup_rate`` of pairs repeats the fragment of an earlier-drawn pair
    (a PCR duplicate, with its own qualities and errors).  Qualities come
    from ``draw_quals(quality)``; a base of quality Q is substituted with
    probability 10^(-Q/10)."""
    L = read_len
    k = rng.integers(0, len(haps), n_pairs)
    isize = np.rint(rng.normal(insert_mean, insert_std, n_pairs)).astype(
        np.int64)
    bad = isize < L
    while bad.any():
        isize[bad] = np.rint(rng.normal(insert_mean, insert_std,
                                        int(bad.sum())))
        bad = isize < L
    flip = rng.random(n_pairs) < 0.5
    u = rng.random(n_pairs)
    start = np.empty(n_pairs, np.int64)
    for h, hap in enumerate(haps):
        sel = k == h
        a = int(np.searchsorted(hap.coord, lo))
        b = int(np.searchsorted(hap.coord, len(hap.coord) if hi is None
                                else hi))
        b = min(b, len(hap.seq))
        span = np.maximum(1, b - a - isize[sel])
        start[sel] = a + (u[sel] * span).astype(np.int64)
    if dup_rate > 0:
        nd = int(round(dup_rate * n_pairs))
        dst = rng.choice(np.arange(1, n_pairs), nd, replace=False)
        src = (rng.random(nd) * dst).astype(np.int64)    # an earlier pair
        for arr in (k, isize, flip, start):
            arr[dst] = arr[src]
    s1 = np.empty((n_pairs, L), np.uint8)
    s2 = np.empty((n_pairs, L), np.uint8)
    p_first = np.empty(n_pairs, np.int64)
    p_last = np.empty(n_pairs, np.int64)
    cols = np.arange(L)
    for h, hap in enumerate(haps):
        sel = np.nonzero(k == h)[0]
        st, ins = start[sel], isize[sel]
        s1[sel] = hap.seq[st[:, None] + cols]
        far = st + ins - L
        s2[sel] = 3 - hap.seq[far[:, None] + (L - 1 - cols)]
        p_first[sel] = hap.coord[st]
        p_last[sel] = hap.coord[far]
    r1 = np.where(flip[:, None], s2, s1)
    r2 = np.where(flip[:, None], s1, s2)
    quals = []
    for r in (r1, r2):
        q = draw_quals(rng, r.shape, quality)
        e = rng.random(r.shape) < 10.0 ** (-q.astype(np.float64) / 10)
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        quals.append(q)
    pos1 = np.where(flip, p_last, p_first)
    pos2 = np.where(flip, p_first, p_last)
    killed = np.zeros(n_pairs, bool)
    n_kill = int(round(kill_frac * n_pairs))
    if n_kill:
        killed[rng.choice(n_pairs, n_kill, replace=False)] = True
        r2[killed, ::9] = (r2[killed, ::9] + 1) % 4
    if repeat is not None:
        cs = np.concatenate([[0], np.cumsum(repeat)])
        left = np.minimum(p_first, p_last)
        right = np.maximum(p_first, p_last) + L
        right = np.minimum(right, len(repeat))
        unique = cs[right] - cs[left] == 0
    else:
        unique = np.ones(n_pairs, bool)
    return Reads(r1, r2, np.full(n_pairs, tid, np.int32), pos1, pos2, flip,
                 killed, unique, *quals)


def concat_reads(parts: Sequence[Reads], rng) -> Reads:
    """The parts' pairs in one shuffled stream."""
    cat = [np.concatenate(x) for x in zip(*parts)]
    order = rng.permutation(len(cat[0]))
    return Reads(*[c[order] for c in cat])


def write_fastq(path: str, prefix: str, seqs: np.ndarray,
                quals: np.ndarray) -> None:
    """Records ``@<prefix><index, 9 digits>``, the bases, ``+``, the
    bases' phred qualities: built as one byte matrix."""
    n, L = seqs.shape
    name = np.frombuffer(("@" + prefix).encode(), np.uint8)
    w = len(name) + 9
    rec = np.empty((n, w + 1 + L + 3 + L + 1), np.uint8)
    rec[:, :len(name)] = name
    idx = np.arange(n, dtype=np.int64)
    for d in range(9):
        rec[:, w - 1 - d] = 48 + (idx // 10 ** d) % 10
    rec[:, w] = 10
    rec[:, w + 1:w + 1 + L] = BASES[seqs]
    rec[:, w + 1 + L:w + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + 4 + L:w + 4 + 2 * L] = 33 + quals
    rec[:, -1] = 10
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())

