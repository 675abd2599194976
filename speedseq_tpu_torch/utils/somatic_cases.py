"""Seeded tumor/normal inputs for the somatic tests and the chip smoke.

A random contig; germline heterozygous SNVs on haplotype B, carried by
both samples; somatic heterozygous SNVs on the tumor's haplotype A only
(VAF ~0.5, purity 1).  No indels, so read coordinates are the
reference's.  ``write_gtf`` places two-exon coding transcripts on the
contig for the ``--gff`` annotator; ``records_mismatch`` holds two var or
somatic runs' records to each other (cuda against cpu, threads against
one thread).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from . import sim
from ..formats.fasta import decode_bases


class TumorNormal(NamedTuple):
    genome: np.ndarray                     # (bp,) uint8 reference
    germline: List[Tuple[int, str, str]]   # (pos0, ref, alt), both samples
    somatic: List[Tuple[int, str, str]]    # (pos0, ref, alt), tumor only
    normal: tuple                          # sim.simulate_pairs output
    tumor: tuple


def tumor_normal(bp: int, normal_pairs: int, tumor_pairs: int, seed: int,
                 read_len: int = 150, germline_rate: float = 0.001,
                 somatic_rate: float = 0.0002) -> TumorNormal:
    """Reads of a normal (haplotypes ref and B) and a tumor (haplotypes A
    and B), insert 320 ± 50, 0.2 % base errors, Q35."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, bp).astype(np.uint8)
    hap_b, germline, _ = sim.mutate(g, rng, snv_rate=germline_rate,
                                    indel_rate=0.0)
    hap_a, somatic, _ = sim.mutate(g, rng, snv_rate=somatic_rate,
                                   indel_rate=0.0)
    # a somatic hit on a germline site would be a third allele: drop it
    taken = {p for p, _, _ in germline}
    for p, _, _ in somatic:
        if p in taken:
            hap_a[p] = g[p]
    somatic = [v for v in somatic if v[0] not in taken]
    normal = sim.simulate_pairs(g, normal_pairs, read_len=read_len,
                                seed=seed + 1, diploid_genome=hap_b,
                                name_prefix="normal")
    tumor = sim.simulate_pairs(hap_a, tumor_pairs, read_len=read_len,
                               seed=seed + 2, diploid_genome=hap_b,
                               name_prefix="tumor")
    return TumorNormal(g, germline, somatic, normal, tumor)


def write_fasta(path: str, name: str, genome: np.ndarray) -> None:
    s = decode_bases(genome).decode()
    with open(path, "w") as fh:
        fh.write(f">{name}\n" + "\n".join(s[i:i + 60]
                                         for i in range(0, len(s), 60)) + "\n")


def write_fastqs(prefix: str, reads: tuple) -> Tuple[str, str]:
    """``reads`` (a simulate_pairs output) as prefix_1.fq / prefix_2.fq."""
    f1, f2 = prefix + "_1.fq", prefix + "_2.fq"
    sim.to_fastq(f1, f2, *reads[:5])
    return f1, f2


def write_gtf(path: str, chrom: str, bp: int, n: int, seed: int) -> None:
    """``n`` two-exon coding transcripts, evenly spaced over the contig,
    alternating strands: exon 1 of 300-600 bp, an intron of 200-800 bp,
    exon 2 of 300-600 bp; the CDS leaves 50 bp of UTR at the transcript's
    outer ends (and up to 2 bp more, so its length is a multiple of 3)."""
    rng = np.random.default_rng(seed)
    step = bp // n
    lines = []
    for k in range(n):
        e1, intron, e2 = (int(x) for x in rng.integers(
            (300, 200, 300), (601, 801, 601)))
        s = k * step + 1 + int(rng.integers(0, step - e1 - intron - e2))
        x1 = (s, s + e1 - 1)
        x2 = (x1[1] + intron + 1, x1[1] + intron + e2)
        c1 = (x1[0] + 50, x1[1])
        c2 = (x2[0], x2[1] - 50)
        c2 = (c2[0], c2[1] - (c1[1] - c1[0] + c2[1] - c2[0] + 2) % 3)
        strand = "+-"[k % 2]
        attrs = f'gene_id "G{k}"; transcript_id "T{k}";'
        lines.append(f"{chrom}\tsim\ttranscript\t{x1[0]}\t{x2[1]}\t.\t"
                     f'{strand}\t.\t{attrs} gene_name "GENE{k}"; '
                     'gene_biotype "protein_coding";')
        for a, b in (x1, x2):
            lines.append(f"{chrom}\tsim\texon\t{a}\t{b}\t.\t{strand}\t.\t"
                         f"{attrs}")
        for a, b in (c1, c2):
            lines.append(f"{chrom}\tsim\tCDS\t{a}\t{b}\t.\t{strand}\t0\t"
                         f"{attrs}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def records_mismatch(a, b):
    """None when two var or somatic record lists agree on CHROM, POS, REF,
    ALT, FILTER, GT, DP, RO, AO, QR, QA, RPL, RPR, SAF, SAR, with GQ
    within 1, QUAL and GL within 0.01 (their last printed digit) and SSC
    within 0.03 (three GL differences); else why."""
    if len(a) != len(b):
        return f"{len(a)} vs {len(b)} records"
    close = lambda x, y, tol=0.0100001: abs(x - y) <= tol
    for x, y in zip(a, b):
        where = f"{x.chrom}:{x.pos}"
        if (x.chrom, x.pos, x.ref, x.alt, x.filter) != (
                y.chrom, y.pos, y.ref, y.alt, y.filter):
            return f"{where}: site differs"
        if any(x.info[k] != y.info[k]
               for k in ("DP", "RO", "AO", "RPL", "RPR", "SAF", "SAR")):
            return f"{where}: INFO counts differ"
        if ("SSC" in x.info) != ("SSC" in y.info) or (
                "SSC" in x.info and not close(float(x.info["SSC"]),
                                              float(y.info["SSC"]),
                                              0.0300001)):
            return f"{where}: SSC {x.info.get('SSC')} vs {y.info.get('SSC')}"
        if not close(x.qual or 0.0, y.qual or 0.0):
            return f"{where}: QUAL {x.qual} vs {y.qual}"
        for sx, sy in zip(x.samples, y.samples):
            if any(sx[k] != sy[k]
                   for k in ("GT", "DP", "RO", "AO", "QR", "QA")):
                return f"{where}: FORMAT counts differ"
            if abs(int(sx["GQ"]) - int(sy["GQ"])) > 1:
                return f"{where}: GQ {sx['GQ']} vs {sy['GQ']}"
            gx = [float(v) for v in str(sx["GL"]).split(",")]
            gy = [float(v) for v in str(sy["GL"]).split(",")]
            if len(gx) != len(gy) or not all(map(close, gx, gy)):
                return f"{where}: GL {sx['GL']} vs {sy['GL']}"
    return None
