"""The plain reference's judgement of one ``realign`` job: lane BAMs of
several libraries re-aligned into one BAM triple, read back with
``bgzf.py`` and held to the reads' origins, to the input lanes, and to
samblaster's duplicate rule run once per library, as upstream's realign
runs it (``bin/speedseq:1895-1973``: ``bamlibs.py`` groups the read
groups by ``LB``, then each library goes through its own samblaster).

The counts of ``align_check.check_align`` hold as in the align cell,
with ``dup_flag_errors`` recomputed here: the key of a signature is the
pair's library as well, and input order is the order the lane BAMs give
(the BAMs in the command's order, each pair where its later mate lies),
which this module extracts itself.  Further counts, each a violation:

- ``rg_errors``: @RG lines of the lanes missing from the output header,
  or lines there that no lane declared; records whose ``RG`` is not the
  read group of the lane their pair came from.
- ``seq_errors``: sampled primary records whose SEQ or QUAL, turned back
  to the read's original orientation, differ from the simulated read.
- ``cross_lane_dups_missed``: pairs that the rule flags because an
  earlier pair of their library in another lane shares the signature,
  left unflagged.
- ``cross_library_dups_flagged``: pairs flagged though no earlier pair of
  their library shares the signature, only one of the other library.

``control`` takes one library for every read group: it expects the
cross-library twins flagged, so a sound output fails it."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from . import bgzf
from .align_check import (FDUP, FREAD1, FREVERSE, FSECONDARY, FSUPP,
                          FUNMAP, _revcomp, _signature, check_align)

NT16 = np.full(16, 4, np.uint8)
NT16[[1, 2, 4, 8]] = [0, 1, 2, 3]          # =ACMGRSVTWYHKDBN: A, C, G, T


class Extract(NamedTuple):
    """The lanes' pairs in input order, each end in its original
    orientation: ``ends[k] = ((seq, qual, rg), (seq, qual, rg))`` for
    read 1 and read 2 (codes 0-4, phred), ``lane[k]`` the BAM that held
    the pair's later mate.  ``records``: primary records taken;
    ``orphans``: names of reads whose mate never came; ``headers``: each
    BAM's header text."""
    names: List[str]
    ends: list
    lane: np.ndarray
    records: int
    orphans: List[str]
    headers: List[str]


def rg_fields(line: str) -> Dict[str, str]:
    return dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)


def rg_lines(text: str) -> List[str]:
    return [ln for ln in text.splitlines() if ln.startswith("@RG")]


def original_read(bam: bgzf.Bam, i: int):
    """(codes, phred) of record ``i`` in the read's original orientation
    (a reverse-strand record's SEQ reverse-complemented, QUAL reversed);
    a record without qualities reads 30 a base."""
    d = bam.data
    o = int(bam.off[i]) + 36 + d[int(bam.off[i]) + 12] + 4 * len(
        bam.cigars[i])
    n = int(bam.l_seq[i])
    raw = np.frombuffer(d, np.uint8, (n + 1) // 2, o)
    nib = np.empty(2 * len(raw), np.uint8)
    nib[0::2], nib[1::2] = raw >> 4, raw & 15
    seq = NT16[nib[:n]]
    qual = np.frombuffer(d, np.uint8, n, o + (n + 1) // 2).copy()
    if n and (qual == 0xFF).all():
        qual[:] = 30
    if bam.flag[i] & FREVERSE:
        seq, qual = _revcomp(seq), qual[::-1].copy()
    return seq, qual


def extract(bam_paths: List[str]) -> Extract:
    """bamtofastq.py over the lane BAMs in turn: primary records with a
    sequence, paired by name across the BAMs."""
    pending: Dict[str, tuple] = {}
    names, ends, lanes, headers = [], [], [], []
    records = 0
    for lane, path in enumerate(bam_paths):
        bam = bgzf.read_bam(path)
        headers.append(bam.text)
        for i in range(len(bam.names)):
            f = int(bam.flag[i])
            if f & (FSECONDARY | FSUPP) or bam.l_seq[i] == 0:
                continue
            records += 1
            seq, qual = original_read(bam, i)
            end = (seq, qual, str(bgzf.record_tags(bam, i).get("RG", "")),
                   bool(f & FREAD1))
            name = bam.names[i]
            mate = pending.pop(name, None)
            if mate is None:
                pending[name] = end
                continue
            r1, r2 = (end, mate) if end[3] else (mate, end)
            names.append(name)
            ends.append((r1[:3], r2[:3]))
            lanes.append(lane)
    return Extract(names, ends, np.asarray(lanes, np.int64), records,
                   list(pending), headers)


def libraries(lines: List[str]) -> Dict[str, str]:
    """Read group ID → library (``LB``, else the ID: bamlibs.py)."""
    out = {}
    for line in lines:
        f = rg_fields(line)
        out.setdefault(f.get("ID", ""), f.get("LB", f.get("ID", "")))
    return out


def expected_duplicates(main: bgzf.Bam, i1: np.ndarray, i2: np.ndarray,
                        order: np.ndarray, key: np.ndarray):
    """samblaster's rule over pairs ``order`` (input order) of the BAM
    ``main`` (pair k's primary records ``i1[k]``, ``i2[k]``), a signature
    scoped by ``key[k]``: (want, first) with ``want[k]`` True for a pair
    an earlier pair of its scope shares the signature with, and
    ``first[k]`` the pair kept for that signature (-1 for a pair with no
    end mapped)."""
    mapped = (main.flag & FUNMAP) == 0
    want = np.zeros(len(i1), bool)
    first = np.full(len(i1), -1, np.int64)
    kept: Dict[tuple, int] = {}
    for k in order:
        a, b = int(i1[k]), int(i2[k])
        ma, mb = bool(mapped[a]), bool(mapped[b])
        if ma and mb:
            sa, sb = _signature(main, a), _signature(main, b)
            if sa[:2] > sb[:2]:
                sa, sb = sb, sa
            sig = ("pair", sa, sb)
        elif ma or mb:
            sig = ("orphan", _signature(main, a if ma else b))
        else:
            continue
        s = (int(key[k]),) + sig
        want[k] = s in kept
        first[k] = kept.setdefault(s, int(k))
    return want, first


def check_realign(prefix: str, lanes: List[str], contigs, reads,
                  name_prefix: str, rng, n_sample: int = 2048,
                  control: bool = False) -> Dict[str, int]:
    """Judge the BAM triple ``<prefix>.bam`` (``.splitters.bam``,
    ``.discordants.bam``, each with ``.bai``) of a realign job over the
    lane BAMs ``lanes`` (in the command's order), whose pairs are
    ``reads`` (``genome.Reads``; pair k named ``<name_prefix><k>``)."""
    out = check_align(prefix, contigs, reads, name_prefix, rng)
    ext = extract(lanes)
    want_lines = list(dict.fromkeys(
        ln for text in ext.headers for ln in rg_lines(text)))
    lib_of_rg = libraries(want_lines)
    main = bgzf.read_bam(prefix + ".bam")
    n_pairs = len(reads.pos1)
    lp = len(name_prefix)

    def pair_of(name):
        s = name[lp:]
        return int(s) if name.startswith(name_prefix) and s.isdigit() \
            else -1

    # read groups: the header's lines, and every record's tag
    got_lines = rg_lines(main.text)
    rg_err = len(set(want_lines) ^ set(got_lines)) + len(got_lines) - len(
        set(got_lines))
    rg_of_name = {nm: e[0][2] for nm, e in zip(ext.names, ext.ends)}
    for b in [main] + [bgzf.read_bam(f"{prefix}.{k}.bam")
                       for k in ("splitters", "discordants")]:
        for i, nm in enumerate(b.names):
            if nm in rg_of_name:
                rg_err += int(bgzf.record_tags(b, i).get("RG")
                              != rg_of_name[nm])
    out["rg_errors"] = rg_err

    # SEQ and QUAL of sampled primaries against the simulated reads
    flag = main.flag.astype(np.int64)
    pair = np.array([pair_of(s) for s in main.names], np.int64)
    prim = ((flag & (FSECONDARY | FSUPP)) == 0) & (pair >= 0) & (
        pair < n_pairs)
    cand = np.nonzero(prim)[0]
    pick = np.sort(rng.choice(cand, min(n_sample, len(cand)),
                              replace=False)) if len(cand) else cand
    seq_err = 0
    for i in pick:
        k = int(pair[i])
        r1 = bool(flag[i] & FREAD1)
        seq, qual = original_read(main, int(i))
        sim = reads.seq1[k] if r1 else reads.seq2[k]
        simq = reads.qual1[k] if r1 else reads.qual2[k]
        seq_err += int(not (np.array_equal(seq, sim)
                            and np.array_equal(qual, simq)))
    out["seq_errors"] = seq_err

    # duplicates: samblaster per library, in the lanes' input order
    r1 = prim & ((flag & FREAD1) != 0)
    r2 = prim & ((flag & FREAD1) == 0)
    c1 = np.bincount(pair[r1], minlength=n_pairs)
    c2 = np.bincount(pair[r2], minlength=n_pairs)
    i1 = np.zeros(n_pairs, np.int64)
    i2 = np.zeros(n_pairs, np.int64)
    i1[pair[r1]] = np.nonzero(r1)[0]
    i2[pair[r2]] = np.nonzero(r2)[0]
    ids = np.array([pair_of(nm) for nm in ext.names], np.int64)
    keep = (ids >= 0) & (ids < n_pairs)
    ids, lane_of = ids[keep], ext.lane[keep]
    ids_ok = (c1[ids] == 1) & (c2[ids] == 1)
    order, lane_of = ids[ids_ok], lane_of[ids_ok]
    lane = np.full(n_pairs, -1, np.int64)
    lane[order] = lane_of
    lib_ids = {lb: j for j, lb in enumerate(dict.fromkeys(
        lib_of_rg.values()))}
    rg_key = np.full(n_pairs, -1, np.int64)
    for nm, e in zip(ext.names, ext.ends):
        k = pair_of(nm)
        if 0 <= k < n_pairs:
            rg_key[k] = lib_ids.get(lib_of_rg.get(e[0][2], e[0][2]), -1)
    lib = np.zeros(n_pairs, np.int64) if control else rg_key
    want, first = expected_duplicates(main, i1, i2, order, lib)
    dup = (main.flag & FDUP) != 0
    mapped = (main.flag & FUNMAP) == 0
    got = np.zeros(n_pairs, bool)
    wrong = 0
    for k in order:
        a, b = int(i1[k]), int(i2[k])
        ends = [dup[x] for x in (a, b) if mapped[x]]
        if not ends:
            wrong += int(dup[a] or dup[b])
            continue
        got[k] = ends[0]
        wrong += int(any(g != want[k] for g in ends))
    out["dup_flag_errors"] = wrong
    scoped = want & (first >= 0)
    other_lane = np.zeros(n_pairs, bool)
    other_lane[order] = lane[np.maximum(first[order], 0)] != lane[order]
    out["cross_lane_dups_missed"] = int((scoped & other_lane & ~got).sum())
    anywhere, _ = expected_duplicates(main, i1, i2, order,
                                      np.zeros(n_pairs, np.int64))
    out["cross_library_dups_flagged"] = int((got & ~want & anywhere).sum())
    return out
