"""Job kind ``align``: FASTQ pairs to the sorted, duplicate-marked BAM
triple through ``speedseq_tpu_torch align`` at the CLI's defaults.

Traffic keys: ``pairs`` a job, ``dup_rate`` (PCR duplicates),
``kill_frac`` (read-2 ends with no clean seed, for mate rescue),
``args`` (further CLI arguments), ``limits``.  Set-up mutates every
contig with the sample design and draws the job's pairs over the whole
genome, repeats included, in proportion to contig length; every job of
a run aligns the same FASTQ pair.  Work is counted in reads."""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np

from benchmark import genome as gm
from benchmark import sample
from benchmark.reference.align_check import check_align

NAME_PREFIX = "r"


def setup(ctx) -> None:
    t = ctx.traffic
    g = ctx.genome
    lens = np.array([len(c) for c in g.contigs], np.float64)
    counts = np.floor(t["pairs"] * lens / lens.sum()).astype(int)
    counts[0] += t["pairs"] - counts.sum()
    parts = []
    for tid, n in enumerate(counts):
        haps = [sample.identity(g.contigs[tid]), sample.germline(ctx, tid)]
        parts.append(sample.simulate(ctx, haps, tid, int(n),
                                     dup_rate=t["dup_rate"],
                                     kill_frac=t["kill_frac"]))
    ctx.reads = gm.concat_reads(parts, ctx.rng)
    ctx.fq = sample.write_fastqs(ctx, ctx.reads, "in", NAME_PREFIX)


def _prefix(ctx, k) -> str:
    return os.path.join(ctx.work, f"job-{k}")


def run(ctx, k) -> dict:
    try:
        rc = ctx.cli(["align", "-R", sample.read_group("HG002"), "-o",
                      _prefix(ctx, k), ctx.fasta, *ctx.fq]
                     + list(ctx.traffic.get("args", [])))
    except Exception:          # a job that raises is a failed job
        traceback.print_exc(file=sys.stderr)
        rc = -1
    return {"ok": rc == 0, "units": 2 * len(ctx.reads.pos1)}


def discard(ctx, k) -> None:
    sample.remove(_prefix(ctx, k))


def check(ctx, k, control: bool = False) -> dict:
    return check_align(_prefix(ctx, k), ctx.genome.contigs, ctx.reads,
                       NAME_PREFIX, ctx.check_rng, control=control)
