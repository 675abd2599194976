"""The plain reference's judgement of one ``align`` job: its BAM triple
and indexes, read back with ``bgzf.py`` and held to the reads' origins
and to rules recomputed here.

Every number is a count of violations, and a sound run has none:

- ``lost_pairs``: input pairs without exactly one primary read 1 and one
  primary read 2 in the BAM, and primary records of no input pair.
- ``order_errors``: records out of coordinate order, in any of the three
  BAMs.
- ``index_errors``: records whose ``bin`` is not the specification's bin
  of their span, and records that a BAI query over a region finds where
  a scan of the file does not, or misses (every BAM, regions drawn from
  the seed).
- ``tag_errors``: sampled primary records whose CIGAR does not cover the
  read, whose ``NM`` or ``AS`` is not the one their CIGAR gives against
  the reference, or whose ``XA`` hits' ``NM`` is not theirs.
- ``misplaced_unique``: pairs whose fragment lies wholly outside every
  repeat copy and neither of whose ends was seed-killed, of which an end
  is unmapped or lies more than 12 bp from its origin (seeding,
  chaining, pairing).
- ``dup_flag_errors``: pairs whose duplicate flags differ from
  samblaster's rule applied to the BAM's own placements: per signature
  (the two ends' contig, unclipped 5' position and strand, in canonical
  order; one end for a pair with one end mapped), the first pair in
  input order is kept, later ones flagged.
- ``side_file_errors``: discordant records that are not the primary
  records of both-mapped, non-proper, non-duplicate pairs (or such
  records missing), and splitter records that are not non-duplicate
  records with an ``SA`` tag (or non-duplicate supplementary records
  missing)."""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
from . import bgzf

FPAIRED, FPROPER, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FREAD1, FREAD2 = 0x10, 0x40, 0x80
FSECONDARY, FDUP, FSUPP = 0x100, 0x400, 0x800
PLACE_TOL = 12
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 4, 6, 1     # BWA-MEM's scores
CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i


def _clips(cig):
    lead = cig[0][1] if cig and cig[0][0] in "SH" else 0
    tail = cig[-1][1] if cig and cig[-1][0] in "SH" else 0
    return lead, tail


def cigar_score(read: np.ndarray, ref: np.ndarray, pos: int, cig
                ) -> tuple:
    """(query bases the CIGAR covers, NM, alignment score) of ``read``
    (codes, in reference orientation) placed at ``pos`` by ``cig``;
    None for the score where the alignment leaves the contig."""
    qi, ri, nm, score, qlen = 0, pos, 0, 0, 0
    for op, n in cig:
        if op in "M=X":
            if ri < 0 or ri + n > len(ref):
                return qlen + n, None, None
            a, b = read[qi:qi + n], ref[ri:ri + n]
            mis = int(((a != b) | (a > 3)).sum())
            nm += mis
            score += (n - mis) * MATCH - mis * MISMATCH
            qi += n
            ri += n
            qlen += n
        elif op == "I":
            nm += n
            score -= GAP_OPEN + GAP_EXT * n
            qi += n
            qlen += n
        elif op == "D":
            nm += n
            score -= GAP_OPEN + GAP_EXT * n
            ri += n
        elif op == "S":
            qi += n
            qlen += n
        elif op == "N":
            ri += n
    return qlen, nm, score


def _parse_cigar(s: str):
    out, num = [], ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, 4)[::-1].astype(np.uint8)


def _signature(bam: bgzf.Bam, i: int):
    """(contig, unclipped 5' position, strand) of a mapped record."""
    lead, tail = _clips(bam.cigars[i])
    rev = int(bam.flag[i] & FREVERSE != 0)
    p5 = (int(bam.pos[i]) + int(bam.reflen[i]) + tail if rev
          else int(bam.pos[i]) - lead)
    return (int(bam.tid[i]), p5, rev)


def _sorted_errors(bam: bgzf.Bam) -> int:
    key_t = np.where(bam.tid < 0, np.iinfo(np.int64).max,
                     bam.tid.astype(np.int64))
    key = key_t * (1 << 32) + np.where(bam.tid < 0, 0, bam.pos)
    return int((np.diff(key) < 0).sum())


def _index_errors(bam: bgzf.Bam, bai_path: str, rng, n_regions: int) -> int:
    errs = 0
    span_end = bam.pos.astype(np.int64) + np.maximum(bam.reflen, 1)
    placed = bam.tid >= 0
    for i in np.nonzero(placed)[0]:
        if bgzf.reg2bin(int(bam.pos[i]), int(span_end[i])) != bam.bin[i]:
            errs += 1
    index = bgzf.read_bai(bai_path)
    for _ in range(n_regions):
        t = int(rng.integers(0, len(bam.refs)))
        beg = int(rng.integers(0, max(1, bam.refs[t][1] - 1)))
        end = beg + int(rng.integers(1, 200_000))
        want = np.nonzero((bam.tid == t) & (bam.pos < end)
                          & (span_end > beg))[0]
        got = bgzf.query_hits(index, t, beg, end, bam.vo)
        got = got[(bam.tid[got] == t) & (bam.pos[got] < end)
                  & (span_end[got] > beg)]
        errs += len(np.setxor1d(want, got))
    return errs


def check_align(prefix: str, contigs: List[np.ndarray], reads,
                name_prefix: str, rng, n_sample: int = 2048,
                n_regions: int = 16, control: bool = False) -> Dict[str, int]:
    """Judge the BAM triple ``<prefix>.bam``, ``.splitters.bam``,
    ``.discordants.bam`` (each with ``.bai``) of an align job over
    ``reads`` (``genome.Reads``; pair k named ``<name_prefix><k>``).
    ``control`` clears the duplicate flags first: the run without its
    duplicate marking."""
    out = {}
    main = bgzf.read_bam(prefix + ".bam")
    if control:
        main = main._replace(flag=main.flag & ~np.uint16(FDUP))
    side = {k: bgzf.read_bam(f"{prefix}.{k}.bam")
            for k in ("splitters", "discordants")}
    n_pairs = len(reads.pos1)
    lp = len(name_prefix)
    pair = np.array([int(s[lp:]) if s.startswith(name_prefix)
                     and s[lp:].isdigit() else -1 for s in main.names],
                    np.int64)
    flag = main.flag.astype(np.int64)
    prim = (flag & (FSECONDARY | FSUPP)) == 0
    stray = int((prim & ((pair < 0) | (pair >= n_pairs))).sum())
    ok = prim & (pair >= 0) & (pair < n_pairs)
    r1 = ok & (flag & FREAD1 != 0)
    r2 = ok & (flag & FREAD2 != 0)
    c1 = np.bincount(pair[r1], minlength=n_pairs)
    c2 = np.bincount(pair[r2], minlength=n_pairs)
    out["lost_pairs"] = int(((c1 != 1) | (c2 != 1)).sum()) + stray
    whole = (c1 == 1) & (c2 == 1)
    i1 = np.full(n_pairs, -1, np.int64)
    i2 = np.full(n_pairs, -1, np.int64)
    i1[pair[r1]] = np.nonzero(r1)[0]
    i2[pair[r2]] = np.nonzero(r2)[0]

    out["order_errors"] = _sorted_errors(main) + sum(
        _sorted_errors(b) for b in side.values())
    out["index_errors"] = _index_errors(main, prefix + ".bam.bai", rng,
                                        n_regions) + sum(
        _index_errors(b, f"{prefix}.{k}.bam.bai", rng, n_regions // 4)
        for k, b in side.items())

    mapped = ~(flag & FUNMAP).astype(bool)
    lead = np.array([_clips(c)[0] for c in main.cigars], np.int64)
    left = main.pos.astype(np.int64) - lead

    def at_origin(idx, tpos):
        good = idx >= 0
        j = np.where(good, idx, 0)
        return (good & mapped[j] & (main.tid[j] == reads.tid)
                & (np.abs(left[j] - tpos) <= PLACE_TOL))

    o1, o2 = at_origin(i1, reads.pos1), at_origin(i2, reads.pos2)
    bad_place = np.nonzero(reads.unique & ~reads.killed & ~(o1 & o2))[0]
    out["misplaced_unique"] = len(bad_place)
    out["details"] = [f"misplaced {name_prefix}{k:09d}" for k in bad_place[:8]]

    # tags and scores on a sample of primary mapped records
    cand = np.nonzero(prim & mapped & (pair >= 0) & (pair < n_pairs))[0]
    sample = np.sort(rng.choice(cand, min(n_sample, len(cand)),
                                replace=False)) if len(cand) else cand
    tag_err = 0
    for i in sample:
        i = int(i)
        seq = np.frombuffer(bgzf.record_seq(main, i).encode(), np.uint8)
        read = CODE[seq]
        tags = bgzf.record_tags(main, i)
        ref = contigs[int(main.tid[i])]
        qlen, nm, score = cigar_score(read, ref, int(main.pos[i]),
                                      main.cigars[i])
        bad = (qlen != len(read) or nm is None or tags.get("NM") != nm
               or tags.get("AS") != score)
        rev = bool(main.flag[i] & FREVERSE)
        for hit in str(tags.get("XA", "")).split(";"):
            if not hit:
                continue
            chrom, spos, cig, hnm = hit.split(",")
            t = [n for n, _ in main.refs].index(chrom)
            hrev = spos[0] == "-"
            hread = _revcomp(read) if hrev != rev else read
            _, xnm, _ = cigar_score(hread, contigs[t], int(spos[1:]) - 1,
                                    _parse_cigar(cig))
            bad |= xnm is None or xnm != int(hnm)
        tag_err += bool(bad)
    out["tag_errors"] = tag_err

    # duplicate flags against samblaster's rule, in input order
    dup = (flag & FDUP) != 0
    seen_pair, seen_orph = set(), set()
    dup_err = 0
    for k in np.nonzero(whole)[0]:
        a, b = int(i1[k]), int(i2[k])
        ma, mb = bool(mapped[a]), bool(mapped[b])
        if ma and mb:
            sa, sb = _signature(main, a), _signature(main, b)
            if sa[:2] > sb[:2]:
                sa, sb = sb, sa
            key, seen = (sa, sb), seen_pair
        elif ma or mb:
            key, seen = _signature(main, a if ma else b), seen_orph
        else:
            dup_err += int(dup[a] or dup[b])
            continue
        want = key in seen
        seen.add(key)
        got = [dup[x] for x, m in ((a, ma), (b, mb)) if m]
        dup_err += int(any(g != want for g in got))
    out["dup_flag_errors"] = dup_err

    # side files against the BAM's own records
    side_err = 0
    both = mapped & ((flag & FMUNMAP) == 0) & (flag & FPAIRED != 0)
    want = {(main.names[i], int(flag[i])) for i in np.nonzero(
        prim & both & ((flag & FPROPER) == 0) & ~dup)[0]}
    d = side["discordants"]
    got = [(d.names[i], int(d.flag[i])) for i in range(len(d.names))]
    side_err += len(want.symmetric_difference(got)) + len(got) - len(
        set(got))
    has_sa = set()
    for i in np.nonzero(mapped & ~dup)[0]:
        o = int(main.off[i])
        rec = main.data[o:o + 4 + struct.unpack_from("<i", main.data, o)[0]]
        if flag[i] & FSUPP or (b"SAZ" in rec
                               and "SA" in bgzf.record_tags(main, int(i))):
            has_sa.add((main.names[i], int(flag[i]), int(main.pos[i])))
    s = side["splitters"]
    got_s = {(s.names[i], int(s.flag[i]), int(s.pos[i]))
             for i in range(len(s.names))}
    supp = {(main.names[i], int(flag[i]), int(main.pos[i]))
            for i in np.nonzero(mapped & ~dup & (flag & FSUPP != 0))[0]}
    side_err += len(got_s - has_sa) + len(supp - got_s)
    out["side_file_errors"] = side_err
    return out
