"""The port's var and somatic over several contigs, against the JAX CLI, on
the CPU: the shape of tests/test_wgs_shape.py (three contigs, so records
with tid > 0 and windows per contig; a pileup hotspot on the second
contig, left out by a windows BED), cut to tier-1 size.

Three random contigs of 12, 9 and 6 kbp (seed 31).  The normal carries
germline SNVs and 1-4 bp indels at the rates of tests/test_var.py, with
SNV pairs 1-2 bp apart planted for the haplotype scan; the tumor carries
the normal's germline haplotype and tumor-only SNVs; both at 14x of 100
bp pairs, and the normal 40x more over chrB's hotspot (reads with 4
SNVs of their own).  Both BAMs are
aligned once by the port on the CPU.  Then the port's CLI against the JAX
CLI: ``var`` on the normal, ``var -w`` with a windows BED that leaves the
hotspot out, and ``somatic`` on the pair.  Records are held as the
single-contig tests hold them: var as tests/test_torch_var.py does
(``somatic_cases.records_mismatch``), somatic as
tests/test_torch_somatic.py does (a site whose JAX SSC lies within 0.03
of the threshold may change FILTER or be kept on one side only).
"""

import gzip

import numpy as np
import pytest
import torch

from speedseq_tpu import cli as jcli
from speedseq_tpu.formats.vcf import read_vcf as jread_vcf
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.fasta import decode_bases
from speedseq_tpu_torch.formats.vcf import read_vcf
from speedseq_tpu_torch.utils import sim
from speedseq_tpu_torch.utils.metrics import metrics
from speedseq_tpu_torch.utils.somatic_cases import records_mismatch

# one intra-op thread a worker (tests/test_torch_somatic.py says why)
torch.set_num_threads(1)

CHROMS = (("chrA", 12_000), ("chrB", 9_000), ("chrC", 6_000))
HOT_LO, HOT_HI = 3_000, 5_500            # chrB pileup hotspot
SSC_MIN = 18.0


def _pairs(genome, depth, seed, prefix, **kw):
    n = int(depth * len(genome) / 200)
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(
        genome, n, read_len=100, seed=seed, name_prefix=prefix, **kw)
    return names, s1, q1, s2, q2


def _join(parts):
    return (sum((list(p[0]) for p in parts), []),
            *(np.concatenate([p[k] for p in parts]) for k in range(1, 5)))


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("twgs")
    rng = np.random.default_rng(31)
    fa = str(d / "wgs.fa")
    normal, tumor = [], []
    with open(fa, "w") as fh:
        for k, (name, bp) in enumerate(CHROMS):
            g = rng.integers(0, 4, bp).astype(np.uint8)
            s = decode_bases(g).decode()
            fh.write(f">{name}\n" + "\n".join(
                s[i:i + 60] for i in range(0, bp, 60)) + "\n")
            hap, germ, coord = sim.mutate(g, rng, snv_rate=0.003,
                                          indel_rate=0.0005)
            taken = np.array([p for p, _, _ in germ] or [-100])
            for i, pos in enumerate(range(300, bp - 300, 900)):
                h = np.searchsorted(coord, pos)
                gap = 1 + i % 2
                if (np.abs(taken - pos).min() > 12 and h + gap < len(coord)
                        and coord[h + gap] == pos + gap):
                    for x in (h, h + gap):
                        hap[x] = (hap[x] + 1) % 4
            som, _, _ = sim.mutate(g, rng, snv_rate=0.002, indel_rate=0.0)
            normal.append(_pairs(g, 14, 100 + k, f"n{name}",
                                 diploid_genome=hap, coord_map=coord))
            tumor.append(_pairs(som, 14, 200 + k, f"t{name}",
                                diploid_genome=hap, coord_map=coord))
            if name == "chrB":       # the hotspot's reads carry 4 SNVs
                hot = g[HOT_LO:HOT_HI].copy()
                hot[500:2001:500] = (hot[500:2001:500] + 2) % 4
                normal.append(_pairs(hot, 40, 300, "hot"))
    bams = {}
    for sample, parts in (("normal", normal), ("tumor", tumor)):
        f1, f2 = str(d / f"{sample}_1.fq"), str(d / f"{sample}_2.fq")
        sim.to_fastq(f1, f2, *_join(parts))
        sm = sample.upper()
        align_fastq(fa, f1, f2, out_prefix=str(d / sample),
                    config=AlignConfig(batch_size=512, rg_string=(
                        f"@RG\\tID:{sm[0]}\\tSM:{sm}")), device="cpu")
        bams[sample] = str(d / f"{sample}.bam")
    bed = str(d / "windows.bed")
    with open(bed, "w") as fh:
        for name, bp in CHROMS:
            cuts = ((0, HOT_LO), (HOT_HI, bp)) if name == "chrB" else (
                (0, bp // 2), (bp // 2, bp))
            fh.write("".join(f"{name}\t{a}\t{b}\n" for a, b in cuts))
    return d, fa, bams, bed


def _both(d, tag, argv):
    """The JAX CLI and the port's CLI (on the CPU) on one command line;
    returns their records."""
    assert jcli.main([argv[0], "-o", str(d / f"jax-{tag}"), *argv[1:]]) == 0
    metrics.reset()
    assert cli.main([argv[0], "--device", "cpu", "-o", str(d / f"port-{tag}"),
                     *argv[1:]]) == 0
    assert metrics.snapshot().get("var.windows_failed", 0) == 0
    _, want = jread_vcf(str(d / f"jax-{tag}.vcf.gz"))
    _, got = read_vcf(str(d / f"port-{tag}.vcf.gz"))
    return got, want


@pytest.mark.parametrize("windows", [False, True],
                         ids=["default-windows", "bed-without-hotspot"])
def test_var_over_three_contigs_matches_jax(wgs, windows):
    d, fa, bams, bed = wgs
    tag = "var-bed" if windows else "var"
    got, want = _both(d, tag, ["var", *(["-w", bed] if windows else []), fa,
                               bams["normal"]])
    assert records_mismatch(got, want) is None, records_mismatch(got, want)
    per = {c: sum(r.chrom == c for r in got) for c, _ in CHROMS}
    assert all(n >= 5 for n in per.values()), per
    hot = [r for r in got if r.chrom == "chrB" and
           HOT_LO < r.pos <= HOT_HI]
    assert (not hot) if windows else hot, len(hot)
    with gzip.open(str(d / f"port-{tag}.vcf.gz"), "rt") as fh:
        chroms = [l.split("\t", 1)[0] for l in fh if not l.startswith("#")]
    assert chroms == sorted(chroms, key=[c for c, _ in CHROMS].index)


def test_somatic_over_three_contigs_matches_jax(wgs):
    d, fa, bams, _ = wgs
    got, want = _both(d, "somatic", ["somatic", fa, bams["normal"],
                                     bams["tumor"]])
    key = lambda r: (r.chrom, r.pos, r.ref, tuple(r.alt))
    jm, pm = {key(r): r for r in want}, {key(r): r for r in got}
    near = {k for k, r in jm.items()
            if abs(float(r.info["SSC"]) - SSC_MIN) <= 0.03}
    assert set(jm) - set(pm) <= near
    assert all(abs(float(pm[k].info["SSC"]) - SSC_MIN) <= 0.0600001
               for k in set(pm) - set(jm))
    both = [k for k in jm if k in pm]
    assert {k[0] for k in both} == {c for c, _ in CHROMS}
    assert len(near) <= 2, len(near)
    for k in both:
        a, b = pm[k], jm[k]
        if k in near:       # FILTER may differ at the threshold
            a.filter = b.filter
        assert records_mismatch([a], [b]) is None, (k, records_mismatch(
            [a], [b]))
    with open(d / "port-somatic.ped") as a, open(d / "jax-somatic.ped") as b:
        assert a.read() == b.read()
