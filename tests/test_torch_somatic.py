"""The port's somatic calling and --gff annotation against the JAX
package's, on the CPU.

- (a) ``ssc_score`` and ``somatic_filter``: the numbers of
  tests/test_var.py:127-133; PASS / kept / dropped on hand-made records;
- (b) ``pooled_joint_genotypes`` against the JAX one on random GLs: gn
  and gt equal, gq and qual within 1e-4;
- (c) ``somatic --gff`` through the port's CLI against the JAX CLI on a
  random 12 kbp genome (the set-up of tests/test_var.py:135-160, with
  germline SNVs added to both samples), both BAMs aligned once by the
  port on the CPU: headers equal apart from ##source; CHROM, POS, REF,
  ALT, FILTER, the INFO counts and the per-sample GT/DP/RO/AO/QR/QA
  equal; QUAL and GL within 0.0100001 (tests/test_torch_var.py's), GQ within 1,
  SSC within 0.0300001 (three GL differences).  A site whose JAX SSC lies
  within 0.03 of -S may change FILTER (or be kept on one side only), so
  its FILTER is not compared; such sites are counted.  The PED files are
  equal;
- (d) the annotator: the cases of tests/test_aux.py:500-604 against the
  port's copy (and the JAX Annotator on the same calls), and ``var
  --gff`` / ``somatic --gff`` CSQ equal to the JAX CLI's;
- (e) ``apply_balance_filter=False`` gives the JAX ``run_var``'s records
  with the same setting.
"""

import os

import numpy as np
import pytest
import torch

from speedseq_tpu import cli as jcli
from speedseq_tpu.formats.vcf import read_vcf as jread_vcf
from speedseq_tpu.var import device as jdevice
from speedseq_tpu.var.annotate import Annotator as JAnnotator
from speedseq_tpu.var.engine import VarConfig as JVarConfig
from speedseq_tpu.var.engine import run_var as jax_run_var
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.vcf import VCFHeader, VCFRecord, VCFWriter, read_vcf
from speedseq_tpu_torch.utils import somatic_cases
from speedseq_tpu_torch.utils.metrics import metrics
from speedseq_tpu_torch.var import SomaticConfig, run_somatic
from speedseq_tpu_torch.var import device as tdevice
from speedseq_tpu_torch.var.annotate import Annotator, annotate_vcf
from speedseq_tpu_torch.var.caller_space import GT_PAIRS, N_GT
from speedseq_tpu_torch.var.engine import VarConfig, run_var
from speedseq_tpu_torch.var.somatic import somatic_filter, ssc_score

# The tier-1 run puts six pytest workers on the host's cores, and each
# worker imports every test file.  With torch's default of one intra-op
# thread per core, two workers running the port's CPU path (thousands of
# small ops) spin against each other: 870 s instead of 34 s for this
# module's fixture.  One thread per worker process (this applies to the
# whole process, not only this module).
torch.set_num_threads(1)

SSC_MIN = 18.0
INFO_EQ = ("DP", "RO", "AO", "RPL", "RPR", "SAF", "SAR")
FMT_EQ = ("GT", "DP", "RO", "AO", "QR", "QA")


# ------------------------------------------------------------- (a) the filter

def test_ssc_math():
    # LOD_NORM = 0 - (-8) = 8; LOD_TUMOR = max(0-(-20), -15-(-20)) = 20
    assert ssc_score([0.0, -8.0, -40.0], [-20.0, 0.0, -15.0]) == 28.0


def _rec(ngt, ngl, tgt, tgl, qual=30.0):
    return VCFRecord(
        chrom="c", pos=9, id=".", ref="A", alt=["T"], qual=qual, filter=".",
        info={"DP": 40, "RO": 30}, format=["GT", "GL"],
        samples=[{"GT": ngt, "GL": ",".join(map(str, ngl))},
                 {"GT": tgt, "GL": ",".join(map(str, tgl))}])


@pytest.mark.parametrize("only", [False, True])
def test_somatic_filter_pass_keep_drop(only):
    fn = somatic_filter(SomaticConfig(only_somatic=only))
    # SSC 28 with a hom-ref normal: PASS, SSC first in INFO
    r = fn(_rec("0/0", [0.0, -8.0, -40.0], "0/1", [-20.0, 0.0, -15.0]))
    assert r.filter == "PASS" and list(r.info)[:2] == ["SSC", "DP"]
    assert r.info["SSC"] == 28.0
    # SSC 6: kept non-PASS (normal 0/0, tumor not, QUAL over -q) unless
    # --only-somatic
    low = _rec("0/0", [0.0, -2.0, -9.0], "0/1", [-4.0, 0.0, -9.0])
    r = fn(low)
    if only:
        assert r is None
    else:
        assert r.filter == "." and r.info["SSC"] == 6.0
    # germline (normal 0/1), tumor 0/0, QUAL under -q, one sample: dropped
    assert fn(_rec("0/1", [-9.0, 0.0, -9.0], "0/1", [-20.0, 0.0, -15.0])) is None
    assert fn(_rec("0/0", [0.0, -2.0, -9.0], "0/0", [0.0, -1.0, -9.0])) is None
    assert fn(_rec("0/0", [0.0, -2.0, -9.0], "0/1", [-4.0, 0.0, -9.0],
                   qual=0.0)) is None
    one = _rec("0/0", [0.0, -8.0, -40.0], "0/1", [-20.0, 0.0, -15.0])
    one.samples = one.samples[:1]
    assert fn(one) is None


# ------------------------------------------------------- (b) the joint model

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pooled_joint_genotypes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = 300
    gl = rng.normal(0.0, 4.0, (S, 2, N_GT)).astype(np.float32)
    n_alts = rng.integers(1, 4, S)
    hi = np.array([max(j, k) for j, k in GT_PAIRS])
    gl[np.broadcast_to(hi[None, None, :] > n_alts[:, None, None],
                       gl.shape)] = -1e9
    gl -= gl.max(axis=2, keepdims=True)
    want = jdevice.pooled_joint_genotypes(gl, 0.001)
    got = tdevice.pooled_joint_genotypes(gl, 0.001, device="cpu")
    np.testing.assert_array_equal(got.gn, want.gn)
    np.testing.assert_array_equal(got.gt, want.gt)
    np.testing.assert_allclose(got.gq, want.gq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.qual, want.qual, atol=1e-4, rtol=0)


def test_pooled_joint_genotypes_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.pooled_joint_genotypes(np.zeros((1, 2, N_GT), np.float32),
                                       0.001)


# ------------------------------------------------------------ (c) end to end

@pytest.fixture(scope="module")
def somatic_inputs(tmp_path_factory):
    """A random 12 kbp genome; normal and tumor at 25x of 100 bp pairs
    (germline SNVs at 0.1 % in both, tumor-only SNVs at 0.2 %), aligned by
    the port on the CPU; a GTF of four two-exon transcripts; the JAX CLI's
    ``somatic --gff`` over the two BAMs."""
    d = tmp_path_factory.mktemp("tsom")
    case = somatic_cases.tumor_normal(12_000, 1500, 1500, seed=5,
                                      read_len=100, somatic_rate=0.002)
    fa = str(d / "s.fa")
    somatic_cases.write_fasta(fa, "s", case.genome)
    gtf = str(d / "s.gtf")
    somatic_cases.write_gtf(gtf, "s", 12_000, 4, seed=5)
    bams = {}
    for name, reads in (("normal", case.normal), ("tumor", case.tumor)):
        f1, f2 = somatic_cases.write_fastqs(str(d / name), reads)
        sm = name.upper()
        align_fastq(fa, f1, f2, out_prefix=str(d / name),
                    config=AlignConfig(batch_size=512, rg_string=(
                        f"@RG\\tID:{sm[0]}\\tSM:{sm}")), device="cpu")
        bams[name] = str(d / f"{name}.bam")
    assert jcli.main(["somatic", "--gff", gtf, "-o", str(d / "jax"), fa,
                      bams["normal"], bams["tumor"]]) == 0
    return d, fa, gtf, bams, case


def _ssc(r):
    return float(r.info["SSC"])


def _floats(v):
    return [float(x) for x in str(v).split(",")]


def _assert_site_equal(a, b, filter_too=True):
    """``a`` (port) against ``b`` (JAX) under the module's rules."""
    where = (a.chrom, a.pos)
    assert (a.chrom, a.pos, a.ref, a.alt) == (b.chrom, b.pos, b.ref, b.alt)
    if filter_too:
        assert a.filter == b.filter, where
    for k in INFO_EQ:
        assert a.info[k] == b.info[k], (where, k)
    assert a.info.get("CSQ") == b.info.get("CSQ"), where
    assert abs((a.qual or 0.0) - (b.qual or 0.0)) <= 0.0100001, where
    for sa, sb in zip(a.samples, b.samples):
        for k in FMT_EQ:
            assert sa[k] == sb[k], (where, k)
        assert abs(int(sa["GQ"]) - int(sb["GQ"])) <= 1, where
        assert np.allclose(_floats(sa["GL"]), _floats(sb["GL"]),
                           atol=0.0100001, rtol=0), where


def test_somatic_end_to_end_matches_jax(somatic_inputs):
    d, fa, gtf, bams, case = somatic_inputs
    metrics.reset()
    assert cli.main(["somatic", "--device", "cpu", "--gff", gtf, "-o",
                     str(d / "port"), fa, bams["normal"], bams["tumor"]]) == 0
    snap = metrics.snapshot()
    assert snap.get("var.windows_failed", 0) == 0
    assert snap["var.genotype_programs.cpu"] >= 1
    got = str(d / "port.vcf.gz")
    assert os.path.exists(got + ".tbi")
    hj, rj = jread_vcf(str(d / "jax.vcf.gz"))
    hp, rp = read_vcf(got)
    no_src = lambda lines: [l for l in lines if not l.startswith("##source")]
    assert no_src(hp.lines) == no_src(hj.lines)
    assert any(l.startswith("##INFO=<ID=SSC") for l in hp.lines)
    assert hp.samples == ["NORMAL", "TUMOR"]
    with open(d / "port.ped") as a, open(d / "jax.ped") as b:
        assert a.read() == b.read()

    key = lambda r: (r.chrom, r.pos, r.ref, tuple(r.alt))
    jm, pm = {key(r): r for r in rj}, {key(r): r for r in rp}
    near = {k for k, r in jm.items() if abs(_ssc(r) - SSC_MIN) <= 0.03}
    # a site kept on one side only must sit at the threshold
    assert set(jm) - set(pm) <= near
    assert all(abs(_ssc(pm[k]) - SSC_MIN) <= 0.0600001
               for k in set(pm) - set(jm))
    both = [k for k in jm if k in pm]
    assert len(both) >= 15 and len(near) <= 2, (len(both), len(near))
    for k in both:
        a, b = pm[k], jm[k]
        assert abs(_ssc(a) - _ssc(b)) <= 0.0300001, k
        assert list(a.info)[0] == "SSC"
        _assert_site_equal(a, b, filter_too=k not in near)
    # the planted tumor-only SNVs come out PASS (tests/test_var.py:171)
    truth = {p for p, _, _ in case.somatic}
    passed = [r for r in rp if r.filter == "PASS"]
    assert sum(r.pos in truth for r in passed) >= 0.6 * len(truth)
    assert all(r.samples[0]["GT"] == "0/0" for r in passed)
    assert any(r.info["CSQ"].split("|")[0] not in (
        "intergenic_variant", "upstream_gene_variant",
        "downstream_gene_variant", "intron_variant") for r in rp)


def test_somatic_threads_match(somatic_inputs, tmp_path):
    """-t 4 over a 4-window BED writes the bytes of -t 1."""
    d, fa, _, bams, _ = somatic_inputs
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"s\t{a}\t{a + 3000}\n"
                           for a in range(0, 12_000, 3000)))
    outs = {}
    for t in (1, 4):
        outs[t] = run_somatic(fa, bams["normal"], bams["tumor"],
                              str(tmp_path / f"t{t}.vcf.gz"),
                              windows_bed=str(bed),
                              config=SomaticConfig(threads=t), device="cpu")
    with open(outs[1], "rb") as a, open(outs[4], "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(tmp_path / "t1.ped")


def test_somatic_defaults_to_cuda(somatic_inputs, tmp_path, monkeypatch):
    d, fa, _, bams, _ = somatic_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_somatic(fa, bams["normal"], bams["tumor"],
                    str(tmp_path / "x.vcf.gz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["somatic", "-o", str(tmp_path / "y"), fa, bams["normal"],
                  bams["tumor"]])


# ---------------------------------------------------------- (d) the annotator

def _annot_world(tmp_path):
    """Toy genome + GTF (the world of tests/test_aux.py:448-487): one +
    strand coding gene, one - strand gene on chrom 'c' (120 bp).
      geneA (+): exons 21-50, 61-90; CDS 31-50, 61-80
      geneB (-): exon 96-110, CDS 96-110
    Returns the port's and the JAX package's Annotator over it."""
    g = ["A"] * 120
    cds_a = "ATGGCTTGGAAACGTACGTACGTACGTACGTACGTACTAA"  # 40 bases: M A W K ...
    for i, ch in enumerate(cds_a[:20]):
        g[30 + i] = ch          # CDS part 1: 31-50 (1-based)
    for i, ch in enumerate(cds_a[20:]):
        g[60 + i] = ch          # CDS part 2: 61-80
    cds_b = "ATGTTTTAA"[::-1].translate(str.maketrans("ACGT", "TGCA"))
    for i, ch in enumerate(cds_b):
        g[95 + i] = ch          # 96-104 on '-' strand reads ATG TTT TAA
    fa = str(tmp_path / "ann.fa")
    with open(fa, "w") as fh:
        fh.write(">c\n" + "".join(g) + "\n")
    gtf = str(tmp_path / "ann.gtf")
    with open(gtf, "w") as fh:
        fh.write("\n".join([
            'c\tx\ttranscript\t21\t90\t.\t+\t.\tgene_id "GA"; '
            'transcript_id "TA"; gene_name "ALPHA"; '
            'gene_biotype "protein_coding";',
            'c\tx\texon\t21\t50\t.\t+\t.\tgene_id "GA"; transcript_id "TA";',
            'c\tx\texon\t61\t90\t.\t+\t.\tgene_id "GA"; transcript_id "TA";',
            'c\tx\tCDS\t31\t50\t.\t+\t0\tgene_id "GA"; transcript_id "TA";',
            'c\tx\tCDS\t61\t80\t.\t+\t0\tgene_id "GA"; transcript_id "TA";',
            'c\tx\ttranscript\t96\t110\t.\t-\t.\tgene_id "GB"; '
            'transcript_id "TB"; gene_name "BETA";',
            'c\tx\texon\t96\t110\t.\t-\t.\tgene_id "GB"; transcript_id "TB";',
            'c\tx\tCDS\t96\t104\t.\t-\t0\tgene_id "GB"; transcript_id "TB";',
        ]) + "\n")
    return Annotator(gtf, fa), JAnnotator(gtf, fa)


def _cons(anns, pos1, ref, alt, feature=None, end1=None, chrom="c"):
    """The CSQ entry for ``feature`` (or the first) from the port's
    annotator, after checking the JAX annotator's string is the same."""
    port, ref_ann = anns
    out = port.csq(chrom, pos1 - 1, ref, [alt], end1=end1)
    assert out is not None
    assert out == ref_ann.csq(chrom, pos1 - 1, ref, [alt], end1=end1)
    for entry in out.split(","):
        f = entry.split("|")
        if (feature is None or f[5] == feature
                or f[0] == "intergenic_variant"):
            return f
    raise AssertionError(out)


def test_annotate_consequences(tmp_path):
    anns = _annot_world(tmp_path)
    f = _cons(anns, 35, "C", "G", "TA")      # GCT→GGT: Ala→Gly missense
    assert f[0] == "missense_variant"
    assert f[1] == "gCt/gGt" and f[2] == "A/G"
    assert (f[3], f[4], f[10]) == ("GA", "ALPHA", "protein_coding")
    assert f[9] == "2"
    f = _cons(anns, 36, "T", "C", "TA")      # GCT→GCC still Ala
    assert f[0] == "synonymous_variant" and f[2] == "A"
    f = _cons(anns, 39, "G", "A", "TA")      # TGG(Trp)→TGA stop
    assert f[0] == "stop_gained" and f[2] == "W/*"
    f = _cons(anns, 32, "T", "C", "TA")      # ATG start codon hit
    assert f[0] == "start_lost"
    f = _cons(anns, 25, "A", "T", "TA")      # exon 1, before CDS
    assert f[0] == "5_prime_UTR_variant" and f[6] == "1/2"
    assert _cons(anns, 85, "A", "T", "TA")[0] == "3_prime_UTR_variant"
    assert _cons(anns, 55, "A", "T", "TA")[0] == "intron_variant"
    assert _cons(anns, 51, "A", "T", "TA")[0] == "splice_donor_variant"
    assert _cons(anns, 59, "A", "T", "TA")[0] == "splice_acceptor_variant"
    assert _cons(anns, 35, "C", "CG", "TA")[0] == "frameshift_variant"
    assert _cons(anns, 35, "CTT", "C", "TA")[0] == "frameshift_variant"
    assert _cons(anns, 16, "A", "T", "TA")[0] == "upstream_gene_variant"
    f = _cons(anns, 102, "C", "T", "TB")     # minus strand ATG→ATA
    assert f[0] == "start_lost"
    assert f[1] == "atG/atA" and f[9] == "1"
    f = _cons(anns, 99, "A", "G", "TB")      # TTT→TTC: Phe→Phe
    assert f[0] == "synonymous_variant" and f[2] == "F"
    f = _cons(anns, 98, "A", "C", "TB")      # TAA→GAA: *→E
    assert f[0] == "stop_lost" and f[2] == "*/E"
    f = _cons(anns, 1, "A", "T", chrom="chrEmpty")
    assert f[0] == "intergenic_variant"
    for a in anns:
        a.close()


def test_annotate_symbolic_and_bnd_alts(tmp_path):
    """Symbolic alts annotate by their span, BND brackets by the
    breakpoint base (the sv --gff route)."""
    anns = _annot_world(tmp_path)
    f = _cons(anns, 31, "N", "<DEL>", "TA", end1=55)
    assert f[0] == "coding_sequence_variant" and f[1] == f[2] == ""
    assert _cons(anns, 53, "N", "<DUP>", "TA", end1=59)[0] == "intron_variant"
    assert _cons(anns, 22, "N", "<DEL>", "TA",
                 end1=29)[0] == "5_prime_UTR_variant"
    assert _cons(anns, 35, "N", "N[c:200[", "TA")[0] == \
        "coding_sequence_variant"
    assert _cons(anns, 55, "N", "]c:10]N", "TA")[0] == "intron_variant"
    for a in anns:
        a.close()


def test_annotate_vcf_cli(tmp_path):
    """annotate_vcf adds the CSQ header and per-record CSQ with the
    reference's 11 fields."""
    import gzip

    for a in _annot_world(tmp_path):
        a.close()
    h = VCFHeader.build([("c", 120)], ["S"], source="t")
    h.add_format("GT", "1", "String", "Genotype")
    out = str(tmp_path / "x.vcf.gz")
    with VCFWriter(out, h) as w:
        w.write(VCFRecord(chrom="c", pos=34, id=".", ref="C", alt=["G"],
                          qual=50.0, filter=".", info={}, format=["GT"],
                          samples=[{"GT": "0/1"}]))
    annotate_vcf(out, str(tmp_path / "ann.gtf"), str(tmp_path / "ann.fa"))
    assert os.path.exists(out + ".tbi")
    lines = list(gzip.open(out, "rt"))
    assert any(l.startswith("##INFO=<ID=CSQ") for l in lines)
    body = [l for l in lines if not l.startswith("#")]
    csq = [kv for kv in body[0].split("\t")[7].split(";")
           if kv.startswith("CSQ=")][0][4:]
    first = csq.split(",")[0].split("|")
    assert len(first) == 11 and first[0] == "missense_variant"


def test_var_gff_and_vep_flag_match_jax_cli(somatic_inputs, tmp_path, capsys):
    """var --gff -A on the tumor BAM: the port's CLI warns about -A, carries
    on, and writes the JAX CLI's records and CSQ."""
    d, fa, gtf, bams, _ = somatic_inputs
    assert jcli.main(["var", "--gff", gtf, "-o", str(tmp_path / "jax"), fa,
                      bams["tumor"]]) == 0
    capsys.readouterr()
    assert cli.main(["var", "--device", "cpu", "--gff", gtf, "-A", "-o",
                     str(tmp_path / "port"), fa, bams["tumor"]]) == 0
    assert "-A (Ensembl VEP) is not bundled" in capsys.readouterr().err
    _, rj = jread_vcf(str(tmp_path / "jax.vcf.gz"))
    _, rp = read_vcf(str(tmp_path / "port.vcf.gz"))
    assert len(rp) == len(rj) >= 15
    for a, b in zip(rp, rj):
        _assert_site_equal(a, b)
        assert len(a.info["CSQ"].split(",")[0].split("|")) == 11


# ------------------------------------------------------ (e) the balance filter

def test_no_balance_filter_matches_jax(somatic_inputs, tmp_path):
    """apply_balance_filter=False (somatic's setting) keeps the records
    with RPL or RPR 0, as the JAX run_var does."""
    d, fa, _, bams, _ = somatic_inputs
    want = jax_run_var(fa, [bams["tumor"]], str(tmp_path / "jax.vcf.gz"),
                       config=JVarConfig(apply_balance_filter=False))
    got = run_var(fa, [bams["tumor"]], str(tmp_path / "port.vcf.gz"),
                  config=VarConfig(apply_balance_filter=False), device="cpu")
    with_filter = run_var(fa, [bams["tumor"]], str(tmp_path / "f.vcf.gz"),
                          device="cpu")
    _, rj = jread_vcf(want)
    _, rp = read_vcf(got)
    assert len(rp) == len(rj)
    for a, b in zip(rp, rj):
        _assert_site_equal(a, b)
    assert len(rp) > len(read_vcf(with_filter)[1])
