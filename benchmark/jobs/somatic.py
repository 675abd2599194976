"""Job kind ``somatic``: a normal and a tumour BAM to one VCF over a
region, through ``speedseq_tpu_torch somatic`` with a BED of windows.

Traffic keys: those of ``var``, with ``normal_pairs`` and
``tumor_pairs`` in place of ``pairs``.  The normal carries the reference
and a germline haplotype; the tumour carries the germline haplotype and
a copy of the reference with the somatic SNVs (purity 1), as
``utils/somatic_cases.py:tumor_normal`` draws them: a somatic SNV that
lands on a germline site is dropped.  Work is counted in Mbp."""

from __future__ import annotations

import os

from benchmark import genome as gm
from benchmark import sample
from benchmark.jobs import var as base
from benchmark.reference.var_check import check_var

region, discard = base.region, base.discard


def setup(ctx) -> None:
    t = ctx.traffic
    tid, lo, hi = region(ctx)
    ref = ctx.genome.contigs[tid]
    ctx.hap = sample.germline(ctx, tid)
    som = gm.mutate(ref, sample.sample_rng(ctx, tid, 1),
                    ctx.config["sample"]["somatic_snv_rate"])
    taken = {p for p, _, _ in ctx.hap.variants}
    seq = som.seq.copy()
    for p, _, _ in som.variants:
        if p in taken:
            seq[p] = ref[p]
    ctx.somatic = gm.Haplotype(seq, som.coord, [
        v for v in som.variants if v[0] not in taken])
    ctx.bams = []
    for name, haps, n in (
            ("NORMAL", [sample.identity(ref), ctx.hap], t["normal_pairs"]),
            ("TUMOR", [ctx.somatic, ctx.hap], t["tumor_pairs"])):
        reads = sample.simulate(ctx, haps, tid, n, lo - base.FLANK,
                                hi + base.FLANK)
        fq1, fq2 = sample.write_fastqs(ctx, reads, name, name[0].lower())
        ctx.bams.append(sample.align(ctx, fq1, fq2,
                                     os.path.join(ctx.work, name), name))
        for f in (fq1, fq2):
            os.remove(f)
    ctx.bed = sample.write_windows(ctx, ctx.genome.names[tid], lo, hi,
                                   t["window_bp"])


def command(ctx, k) -> list:
    return ["somatic", "-w", ctx.bed, "-o", base._prefix(ctx, k),
            ctx.fasta, *ctx.bams]


def run(ctx, k) -> dict:
    return base.run_command(ctx, command(ctx, k))


def check(ctx, k, control: bool = False) -> dict:
    tid, _, _ = region(ctx)
    g = ctx.genome
    return check_var(base._prefix(ctx, k) + ".vcf.gz", ctx.bams, g.contigs,
                     g.names, g.repeat, sample.planted(tid, ctx.hap),
                     sample.planted(tid, ctx.somatic), region(ctx),
                     ctx.check_rng, control=control)
