"""The sample of a run: diploid haplotypes (the reference and one mutated
copy, so every planted variant is heterozygous, as ``utils/sim.py`` and
``utils/somatic_cases.py`` plant them), the reads drawn from them, and
the BAMs aligned from those reads through the program's CLI.

The haplotypes are the configuration's, drawn from its ``sample_seed``:
the sample is one genome, as the reference is, so every seed calls the
same variants and does the same work.  The run's seed draws the reads
(fragments, strands, qualities, errors, duplicates), as a new sequencing
run of that sample would."""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np

from benchmark import genome as gm


def identity(ref: np.ndarray) -> gm.Haplotype:
    return gm.Haplotype(ref, np.arange(len(ref), dtype=np.int64), [])


def planted(tid: int, hap: gm.Haplotype) -> List[Tuple[int, int, str, str]]:
    return [(tid, p, r, a) for p, r, a in hap.variants]


def sample_rng(ctx, tid: int, kind: int) -> np.random.Generator:
    """The configuration's stream for contig ``tid``'s haplotype
    ``kind`` (0 germline, 1 somatic)."""
    return np.random.default_rng(
        [int(ctx.config["sample"]["sample_seed"]), tid, kind])


def germline(ctx, tid: int) -> gm.Haplotype:
    s = ctx.config["sample"]
    return gm.mutate(ctx.genome.contigs[tid], sample_rng(ctx, tid, 0),
                     s["snv_rate"], s.get("indel_rate", 0.0),
                     s.get("max_indel", 8))


def simulate(ctx, haps, tid: int, n_pairs: int, lo: int = 0, hi=None,
             dup_rate: float = 0.0, kill_frac: float = 0.0) -> gm.Reads:
    s = ctx.config["sample"]
    return gm.simulate_pairs(
        ctx.rng, haps, tid, n_pairs, s["read_len"], s["insert_mean"],
        s["insert_std"], s["base_quality"], lo, hi,
        repeat=ctx.genome.repeat[tid], dup_rate=dup_rate,
        kill_frac=kill_frac)


def write_fastqs(ctx, reads: gm.Reads, stem: str, prefix: str):
    fq1 = os.path.join(ctx.work, stem + "_1.fq")
    fq2 = os.path.join(ctx.work, stem + "_2.fq")
    gm.write_fastq(fq1, prefix, reads.seq1, reads.qual1)
    gm.write_fastq(fq2, prefix, reads.seq2, reads.qual2)
    return fq1, fq2


def read_group(name: str) -> str:
    return f"@RG\\tID:{name}\\tSM:{name}\\tLB:{name}-lib1\\tPL:ILLUMINA"


def align(ctx, fq1: str, fq2: str, out: str, sample: str) -> str:
    """``align`` of a FASTQ pair through the CLI; returns the BAM.  Its
    seconds add to the set-up's ``inputs_align`` span."""
    t0 = time.perf_counter()
    rc = ctx.cli(["align", "-R", read_group(sample), "-o", out, ctx.fasta,
                  fq1, fq2])
    ctx.spans["inputs_align"] = (ctx.spans.get("inputs_align", 0.0)
                                 + time.perf_counter() - t0)
    if rc != 0:
        raise RuntimeError(f"align of {fq1} returned {rc}")
    return out + ".bam"


def write_windows(ctx, name: str, start: int, end: int, step: int) -> str:
    """A BED of the region's windows of ``step`` bp (upstream's
    depth-balanced include windows are ~90 kb)."""
    path = os.path.join(ctx.work, "windows.bed")
    with open(path, "w") as fh:
        for a in range(start, end, step):
            fh.write(f"{name}\t{a}\t{min(a + step, end)}\n")
    return path


def remove(prefix: str) -> None:
    d, stem = os.path.split(prefix)
    for f in os.listdir(d or "."):
        if f.startswith(stem + "."):
            os.remove(os.path.join(d, f))
