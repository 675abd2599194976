"""Job kind ``realign``: a sample's coordinate-sorted, duplicate-marked
lane BAMs of several libraries re-aligned into one sorted BAM triple
through ``speedseq_tpu_torch realign`` at the CLI's defaults.

Traffic keys: ``pairs`` a job, ``dup_rate`` (pairs that copy an earlier
pair's fragment), ``twin_rate`` (the share of pairs whose copy lands in
another library than its original: the cross-library twins; the rest of
``dup_rate`` stays in the original's library as PCR duplicates),
``kill_frac``, ``args``, ``limits``.  The configuration's ``sample``
gives ``libraries`` and ``lanes_per_library``.

Set-up draws the pairs over the whole genome, repeats included, in
proportion to contig length, as the ``align`` job does.  Each group of
pairs that share a fragment sends its first pair to a random library
and each copy to the same library, or, with odds ``twin_rate`` over
``dup_rate``, to another; every pair then goes to a random lane of its
library.  Each lane's FASTQ pair, its reads named by their index in the
whole sample, is aligned once through the CLI's ``align`` with the
lane's read group (the ``inputs_align`` span), and deleted.  Every job
re-aligns the same lane BAMs.  Work is counted in reads."""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np

from benchmark import genome as gm
from benchmark import sample
from benchmark.reference.realign_check import check_realign

NAME_PREFIX = "r"
SAMPLE = "HG002"


def read_groups(ctx):
    """The lanes' @RG lines, with ``\\t`` escapes as ``-R`` takes them:
    lane j is in library j // ``lanes_per_library``."""
    s = ctx.config["sample"]
    per = int(s["lanes_per_library"])
    return [f"@RG\\tID:{SAMPLE}.L{j + 1}\\tSM:{SAMPLE}"
            f"\\tLB:{SAMPLE}-lib{j // per + 1}\\tPL:ILLUMINA"
            for j in range(int(s["libraries"]) * per)]


def assign_lanes(rng, reads: gm.Reads, n_lib: int, per_lib: int,
                 dup_rate: float, twin_rate: float) -> np.ndarray:
    """The lane of each pair: a fragment group's first pair in a random
    library, a copy in another library with odds ``twin_rate /
    dup_rate``, else in the first pair's; then a random lane of the
    library."""
    n = len(reads.pos1)
    frag = np.stack([reads.tid.astype(np.int64), reads.pos1, reads.pos2,
                     reads.rev1.astype(np.int64)], 1)
    _, first, group = np.unique(frag, axis=0, return_index=True,
                                return_inverse=True)
    group = group.reshape(-1)
    lib = rng.integers(0, n_lib, len(first))[group]
    away = (np.arange(n) != first[group]) & (
        rng.random(n) < twin_rate / dup_rate)
    lib[away] = (lib[away] + rng.integers(1, n_lib, int(away.sum()))) % n_lib
    return lib * per_lib + rng.integers(0, per_lib, n)


def write_fastq(path: str, index: np.ndarray, seqs: np.ndarray,
                quals: np.ndarray) -> None:
    """Records ``@<NAME_PREFIX><index, 9 digits>`` of the given pairs."""
    bases = gm.BASES[seqs]
    phred = (33 + quals).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"".join(
            b"@%s%09d\n%s\n+\n%s\n" % (NAME_PREFIX.encode(), int(k),
                                       bases[j].tobytes(),
                                       phred[j].tobytes())
            for j, k in enumerate(index)))


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
    ctx.reads = r = gm.concat_reads(parts, ctx.rng)
    s = ctx.config["sample"]
    ctx.rg_lines = read_groups(ctx)
    ctx.lane = assign_lanes(ctx.rng, r, int(s["libraries"]),
                            int(s["lanes_per_library"]), t["dup_rate"],
                            t["twin_rate"])
    ctx.lanes = []
    for j, rg in enumerate(ctx.rg_lines):
        idx = np.nonzero(ctx.lane == j)[0]
        fq = [os.path.join(ctx.work, f"lane{j + 1}_{e}.fq") for e in (1, 2)]
        write_fastq(fq[0], idx, r.seq1[idx], r.qual1[idx])
        write_fastq(fq[1], idx, r.seq2[idx], r.qual2[idx])
        out = os.path.join(ctx.work, f"{SAMPLE}.L{j + 1}")
        t0 = time.perf_counter()
        rc = ctx.cli(["align", "-R", rg, "-o", out, ctx.fasta, *fq])
        ctx.spans["inputs_align"] = (ctx.spans.get("inputs_align", 0.0)
                                     + time.perf_counter() - t0)
        if rc != 0:
            raise RuntimeError(f"align of lane {j + 1} returned {rc}")
        for f in fq:
            os.remove(f)
        ctx.lanes.append(out + ".bam")


def _prefix(ctx, k) -> str:
    return os.path.join(ctx.work, f"job-{k}")


def run(ctx, k) -> dict:
    try:
        rc = ctx.cli(["realign", "-o", _prefix(ctx, k), ctx.fasta,
                      *ctx.lanes] + list(ctx.traffic.get("args", [])))
    except Exception:          # a job that raises is a failed job
        traceback.print_exc(file=sys.stderr)
        rc = -1
    return {"ok": rc == 0, "units": 2 * len(ctx.reads.pos1)}


def discard(ctx, k) -> None:
    sample.remove(_prefix(ctx, k))


def check(ctx, k, control: bool = False) -> dict:
    return check_realign(_prefix(ctx, k), ctx.lanes, ctx.genome.contigs,
                         ctx.reads, NAME_PREFIX, ctx.check_rng,
                         control=control)
