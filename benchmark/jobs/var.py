"""Job kind ``var``: one sample's BAM to a VCF over a region, through
``speedseq_tpu_torch var`` with a BED of windows.

Traffic keys: ``region`` (``contig``, ``start``, ``end``),
``window_bp``, ``pairs`` (aligned in set-up, drawn over the region and
500 bp each side), ``args``, ``limits``.  Work is counted in Mbp of the
region."""

from __future__ import annotations

import os
import sys
import traceback

from benchmark import sample
from benchmark.reference.var_check import check_var

FLANK = 500


def region(ctx):
    r = ctx.traffic["region"]
    return ctx.genome.names.index(r["contig"]), int(r["start"]), int(r["end"])


def setup(ctx) -> None:
    tid, lo, hi = region(ctx)
    ctx.hap = sample.germline(ctx, tid)
    haps = [sample.identity(ctx.genome.contigs[tid]), ctx.hap]
    reads = sample.simulate(ctx, haps, tid, ctx.traffic["pairs"],
                            lo - FLANK, hi + FLANK)
    fq1, fq2 = sample.write_fastqs(ctx, reads, "in", "s")
    ctx.bams = [sample.align(ctx, fq1, fq2, os.path.join(ctx.work, "HG002"),
                             "HG002")]
    for f in (fq1, fq2):
        os.remove(f)
    ctx.bed = sample.write_windows(ctx, ctx.genome.names[tid], lo, hi,
                                   ctx.traffic["window_bp"])


def _prefix(ctx, k) -> str:
    return os.path.join(ctx.work, f"job-{k}")


def command(ctx, k) -> list:
    return ["var", "-w", ctx.bed, "-o", _prefix(ctx, k), ctx.fasta,
            *ctx.bams]


def run(ctx, k) -> dict:
    return run_command(ctx, command(ctx, k))


def run_command(ctx, argv: list) -> dict:
    """One job: the CLI call, failed on a non-zero return, an exception
    or a window that failed (``var.windows_failed``)."""
    from speedseq_tpu_torch.utils.metrics import metrics

    before = metrics.snapshot().get("var.windows_failed", 0)
    try:
        rc = ctx.cli(argv + list(ctx.traffic.get("args", [])))
    except Exception:          # a job that raises is a failed job
        traceback.print_exc(file=sys.stderr)
        rc = -1
    lost = metrics.snapshot().get("var.windows_failed", 0) - before
    _, lo, hi = region(ctx)
    return {"ok": rc == 0 and lost == 0, "units": (hi - lo) / 1e6}


def discard(ctx, k) -> None:
    sample.remove(_prefix(ctx, k))


def check(ctx, k, control: bool = False) -> dict:
    tid, _, _ = region(ctx)
    g = ctx.genome
    return check_var(_prefix(ctx, k) + ".vcf.gz", ctx.bams, g.contigs,
                     g.names, g.repeat, sample.planted(tid, ctx.hap), [],
                     region(ctx), ctx.check_rng, control=control)
