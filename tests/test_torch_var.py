"""The port's var against the JAX package's, on the CPU.

- the genotyping program (``genotype_sites``) on the seeded random
  observations of tests/test_var.py:474-482 (3 samples, seed 5) and
  :832-840 (2 samples pooled, seed 11), and on seed 5 with 1 sample: integer
  outputs equal, GL within 1e-4, QUAL within 1e-3, GQ within 1;
- the haplotype scorer's DP (``banded_sw_score``): all five outputs equal
  on edge-case and tie-heavy lanes;
- ``call_window`` on the hand-built pileups of tests/test_var.py: the
  SiteCalls equal (integer fields and GQ exactly, GL within 1e-4, QUAL
  within 1e-3);
- end to end on a random 10 kbp genome (BAM made once by the JAX
  ``align_fastq``): the port's ``var`` CLI on the CPU gives the JAX
  ``run_var``'s records on CHROM, POS, REF, ALT, FILTER, GT, DP, RO, AO,
  QR, QA, RPL, RPR, SAF and SAR, GQ within 1, and QUAL and GL within one
  unit of their last printed digit (0.01).  The JAX run takes its
  8-virtual-device mesh path, as tests/test_var.py runs it.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from speedseq_tpu.align import pipeline as jpipe
from speedseq_tpu.align.sw import banded_sw_score as jax_sw_score
from speedseq_tpu.formats.sam import SAMRecord as JSAMRecord
from speedseq_tpu.formats.vcf import read_vcf as jread_vcf
from speedseq_tpu.var import caller as jcaller
from speedseq_tpu.var import device as jdevice
from speedseq_tpu.var.engine import run_var as jax_run_var
from speedseq_tpu.var.pileup import build_pileup as jbuild_pileup
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align.sw import banded_sw_score
from speedseq_tpu_torch.formats.fasta import decode_bases
from speedseq_tpu_torch.formats.sam import SAMRecord as TSAMRecord
from speedseq_tpu_torch.formats.vcf import read_vcf
from speedseq_tpu_torch.utils import sim
from speedseq_tpu_torch.utils.metrics import metrics
from speedseq_tpu_torch.utils.var_cases import hap_scan_lanes, random_sites
from speedseq_tpu_torch.var import caller as tcaller
from speedseq_tpu_torch.var import device as tdevice
from speedseq_tpu_torch.var import engine as tengine
from speedseq_tpu_torch.var.pileup import build_pileup as tbuild_pileup

INT_FIELDS = ("gt_idx", "dp", "ro", "ao", "qr", "qa", "rpl", "rpr", "saf",
              "sar")


# --------------------------------------------------------------- genotyping

@pytest.mark.parametrize("n_samples,pooled,seed,S,R", [
    (1, False, 5, 50, 130), (3, False, 5, 50, 130), (2, True, 11, 40, 120)],
    ids=["1-sample", "3-samples", "2-samples-pooled"])
def test_genotype_sites_matches_jax(n_samples, pooled, seed, S, R):
    args = random_sites(seed, S, R, n_samples, 2 if pooled else 3)
    want = jdevice.genotype_sites(*args, 0.001, n_samples, mesh=None,
                                  pooled=pooled)
    got = tdevice.genotype_sites(*args, 0.001, n_samples, device="cpu",
                                 pooled=pooled)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert np.abs(got.gq.astype(int) - want.gq).max() <= 1
    np.testing.assert_allclose(got.gl, want.gl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.qual, want.qual, atol=1e-3, rtol=0)
    assert (got.joint is None) == (not pooled)
    if pooled:
        np.testing.assert_array_equal(got.joint.gn, want.joint.gn)
        np.testing.assert_array_equal(got.joint.gt, want.joint.gt)
        assert np.abs(got.joint.gq.astype(int) - want.joint.gq).max() <= 1
        np.testing.assert_allclose(got.joint.qual, want.joint.qual,
                                   atol=1e-3, rtol=0)


def test_esf_prior_table_matches_jax():
    for th in (0.001, 0.01):
        np.testing.assert_array_equal(tdevice._esf_log_prior_table(th),
                                      jdevice._esf_log_prior_table(th))


def test_gl_terms_match_jax():
    rng = np.random.default_rng(3)
    support = rng.integers(0, 3, (4, 9)).astype(np.int8)
    obs = rng.integers(-1, 4, (4, 9)).astype(np.int8)
    quals = rng.integers(2, 41, (4, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tcaller._gl_terms(torch.from_numpy(support),
                          torch.from_numpy(quals)).numpy(),
        np.asarray(jcaller._gl_terms(support, quals)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tcaller._gl_terms_multi(torch.from_numpy(obs),
                                torch.from_numpy(quals)).numpy(),
        np.asarray(jcaller._gl_terms_multi(obs, quals)), atol=1e-6, rtol=0)


# ------------------------------------------------------- haplotype scorer DP

@pytest.mark.parametrize("seed", [0, 1])
def test_banded_sw_score_matches_jax(seed):
    q, ql, r = hap_scan_lanes(seed)
    want = jax_sw_score(q, ql, r)
    got = banded_sw_score(torch.from_numpy(q), torch.from_numpy(ql),
                          torch.from_numpy(r))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert (ql == 0).any() and (q == 4).any() and (ql < 150).any()


# ------------------------------------------------- call_window on fixtures

GSEQ = "ACGTACGTACGTACGTACGT"
DSEQ = "ACGTACGTACGTTGCATGCAACGTACGTACGT"
# 1,000 bp reads: the haplotype scan's window is Lr = 1088, past the CUDA
# kernel's 1024 (ops/sw_unbanded.py:MAX_LR)
LSEQ = "".join("ACGT"[c] for c in
               np.random.default_rng(13).integers(0, 4, 1000))
NEXT = dict(zip("ACGT", "CGTA"))


def _read(name, seq, pos=0, sample=0, flag=0, qch="I", cigar=None):
    return dict(qname=name, flag=flag, pos=pos, seq=seq, qual=qch * len(seq),
                cigar=cigar or [(0, len(seq))], sample=sample)


def _over(gseq, subs_of, n=12, qch="I", sample=0, prefix="r"):
    out = []
    for i in range(n):
        s = list(gseq)
        for off, b in subs_of(i).items():
            s[off] = b
        out.append(_read(f"{prefix}{i}", "".join(s), sample=sample,
                         flag=16 if i % 2 else 0, qch=qch))
    return out


def _deletion_reads(snp=None, err=None, qch="I"):
    """6 reads with a 3 bp deletion at 14..16 (optionally a SNP at 10 on
    all of them, or an error at 11 on the first), 6 reference reads."""
    out = []
    for i in range(12):
        flag = 16 if i % 2 else 0
        if i < 6:
            s = list(DSEQ[:14] + DSEQ[17:])
            if snp:
                s[10] = snp
            if err and i == 0:
                s[11] = err
            out.append(_read(f"d{i}", "".join(s), flag=flag, qch=qch,
                             cigar=[(0, 14), (2, 3), (0, len(DSEQ) - 17)]))
        else:
            out.append(_read(f"r{i}", DSEQ, flag=flag, qch=qch))
    return out


def _staggered():
    out = []
    for i in range(12):
        start = (i % 3) * 4
        s = list(GSEQ[start:start + 12])
        if i < 4:
            s[10 - start] = "A"
        elif i < 8:
            s[10 - start] = "T"
        out.append(_read(f"r{i}", "".join(s), pos=start,
                         flag=16 if i % 2 else 0))
    return out


def _two_samples(tumor_subs, n, qch_n="I", qch_t="I"):
    out = []
    for i in range(n):
        out.append(_read(f"n{i}", GSEQ, sample=0, qch=qch_n))
        s = list(GSEQ)
        for off, b in tumor_subs(i).items():
            s[off] = b
        out.append(_read(f"t{i}", "".join(s), sample=1, qch=qch_t))
    return out


def _somatic():
    out = [_read(f"n{i}", GSEQ, sample=0, qch="?") for i in range(10)]
    for i in range(12):
        s = list(GSEQ)
        if i < 8:
            s[10] = "A"
        out.append(_read(f"t{i}", "".join(s), sample=1, qch="?"))
    return out


F01 = dict(min_alternate_fraction=0.1)
# (genome, reads, n_samples, CallerConfig kwargs, calls expected)
CASES = {
    "triallelic": (GSEQ, _over(GSEQ, lambda i: {10: "A"} if i < 4 else
                               {10: "T"} if i < 8 else {}), 1, F01, 1),
    "adjacent-snvs-mnp": (GSEQ, _over(GSEQ, lambda i: {8: "G", 9: "T"}
                                      if i < 6 else {}), 1, F01, 1),
    "joint-haplotypes": (GSEQ, _over(GSEQ, lambda i: {8: "G"} if i < 6
                                     else {9: "T"}), 1, F01, 1),
    "pooled-homref": (GSEQ, _two_samples(
        lambda i: {12: "G"} if i < 3 else {}, 20, "+", "+"), 2,
        dict(min_alternate_fraction=0.05, pooled_discrete=True), 1),
    "plain-homref": (GSEQ, _two_samples(
        lambda i: {12: "G"} if i < 3 else {}, 20, "+", "+"), 2,
        dict(min_alternate_fraction=0.05), 0),
    "per-sample-threshold": (GSEQ, _two_samples(
        lambda i: {5: "T"} if i < 4 else {}, 20), 2,
        dict(min_alternate_fraction=0.2), 1),
    "multiallelic-staggered": (GSEQ, _staggered(), 1, F01, 1),
    "hap-vote-error-mnp": (GSEQ, _over(GSEQ, lambda i: {8: "C", 9: "T"}
                                       if i == 0 else {8: "G", 9: "T"}
                                       if i < 6 else {}), 1, F01, 1),
    "hap-vote-error-indel": (DSEQ, _deletion_reads(err="A"), 1, F01, 1),
    "numeric-biallelic": (GSEQ, _over(GSEQ, lambda i: {10: "A"} if i < 3
                                      else {}, n=8, qch="?"), 1, F01, 1),
    "numeric-somatic": (GSEQ, _somatic(), 2,
                        dict(min_alternate_fraction=0.05,
                             min_alternate_count=2, pooled_discrete=True), 1),
    "numeric-mnp": (GSEQ, _over(GSEQ, lambda i: {8: "G", 9: "T"} if i < 5
                                else {}, qch="?"), 1, F01, 1),
    "numeric-indel-snp": (DSEQ, _deletion_reads(snp="A", qch="?"), 1, F01,
                          1),
    "long-reads-mnp": (LSEQ, _over(LSEQ, lambda i: {
        500: NEXT[LSEQ[500]], 501: NEXT[LSEQ[501]]} if i < 6 else {}), 1,
        F01, 1),
}


def _pileup(build, rec_cls, reads, L):
    recs = [(rec_cls(qname=r["qname"], flag=r["flag"], tid=0, pos=r["pos"],
                     mapq=60, cigar=r["cigar"], mtid=-1, mpos=-1, tlen=0,
                     seq=r["seq"], qual=r["qual"]), r["sample"])
            for r in reads]
    return build(recs, 0, L)


@pytest.mark.parametrize("case", sorted(CASES))
def test_call_window_matches_jax(case):
    gseq, reads, n_samples, kw, n_calls = CASES[case]
    g = np.array(["ACGTN".index(c) for c in gseq], np.uint8)
    want = jcaller.call_window(
        g, _pileup(jbuild_pileup, JSAMRecord, reads, len(g)), n_samples,
        jcaller.CallerConfig(**kw))
    got = tcaller.call_window(
        g, _pileup(tbuild_pileup, TSAMRecord, reads, len(g)), n_samples,
        tcaller.CallerConfig(**kw), device="cpu")
    assert len(want) == n_calls and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.offset, a.ref, a.alts, a.types, a.lengths) == (
            b.offset, b.ref, b.alts, b.types, b.lengths)
        for f in ("gt", "gq", "dp", "ro", "ao", "qr", "qa", "rpl", "rpr",
                  "saf", "sar"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        np.testing.assert_allclose(a.gl, b.gl, atol=1e-4, rtol=0)
        assert abs(a.qual - b.qual) <= 1e-3


def test_long_read_window_scans_past_the_kernel_width(monkeypatch):
    """A window of 1,000 bp reads scans its haplotypes at Lr = 1088: on the
    CPU the twin takes that width (its calls equal the JAX package's in
    test_call_window_matches_jax[long-reads-mnp]); on cuda the wide scan
    kernel takes it and gives the twin's calls (tests/test_torch_gpu.py)."""
    from speedseq_tpu_torch.align import sw as tsw

    widths, real = [], tsw.banded_sw_score
    monkeypatch.setattr(tsw, "banded_sw_score", lambda q, ql, r, *a: (
        widths.append(r.shape[1]), real(q, ql, r, *a))[1])
    gseq, reads, n_samples, kw, n_calls = CASES["long-reads-mnp"]
    g = np.array(["ACGT".index(c) for c in gseq], np.uint8)
    got = tcaller.call_window(
        g, _pileup(tbuild_pileup, TSAMRecord, reads, len(g)), n_samples,
        tcaller.CallerConfig(**kw), device="cpu")
    assert widths == [1088] and len(got) == n_calls
    assert got[0].alts == ["".join(NEXT[b] for b in LSEQ[500:502])]


# ---------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def var_inputs(tmp_path_factory):
    """A random 10 kbp genome, a diploid sample with the SNV/indel rates of
    tests/test_var.py, 25x of 100 bp pairs aligned by the JAX package."""
    d = tmp_path_factory.mktemp("tvar")
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 10_000).astype(np.uint8)
    fa = str(d / "g.fa")
    s = decode_bases(g).decode()
    with open(fa, "w") as fh:
        fh.write(">chrV\n" + "\n".join(s[i:i + 60]
                                       for i in range(0, len(s), 60)) + "\n")
    hap, variants, coord = sim.mutate(g, rng, snv_rate=0.003,
                                      indel_rate=0.0005)
    # plant SNV pairs 1-2 bp apart on the haplotype, clear of the other
    # variants, so the haplotype scorer has groups to score
    taken = np.array([p for p, _, _ in variants])
    for i, pos in enumerate(range(400, 9600, 800)):
        h = np.searchsorted(coord, pos)
        gap = 1 + i % 2
        if np.abs(taken - pos).min() > 12 and coord[h + gap] == pos + gap:
            for k in (h, h + gap):
                hap[k] = (hap[k] + 1) % 4
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(
        g, 1250, read_len=100, seed=11, diploid_genome=hap, coord_map=coord)
    sim.to_fastq(str(d / "v1.fq"), str(d / "v2.fq"), names, s1, q1, s2, q2)
    jpipe.align_fastq(fa, str(d / "v1.fq"), str(d / "v2.fq"),
                      out_prefix=str(d / "v"),
                      config=jpipe.AlignConfig(batch_size=128,
                                               sample="NA12878"))
    bam = str(d / "v.bam")
    want = jax_run_var(fa, [bam], str(d / "jax.vcf.gz"))
    return d, fa, bam, want


def _port_cli(fa, bam, prefix, *extra):
    metrics.reset()
    assert cli.main(["var", "--device", "cpu", "-o", prefix, *extra, fa,
                     bam]) == 0
    return prefix + ".vcf.gz"


def test_var_end_to_end_matches_jax(var_inputs):
    d, fa, bam, want = var_inputs
    got = _port_cli(fa, bam, str(d / "port"))
    snap = metrics.snapshot()
    assert snap.get("var.windows_failed", 0) == 0
    assert snap["var.genotype_programs.cpu"] >= 1
    assert os.path.exists(got + ".tbi")
    with gzip.open(got, "rt") as fh:
        assert fh.readline().startswith("##fileformat")
    hj, rj = jread_vcf(want)
    hp, rp = read_vcf(got)
    no_src = lambda lines: [l for l in lines if not l.startswith("##source")]
    assert no_src(hj.lines) == no_src(hp.lines)
    assert hj.samples == hp.samples == ["NA12878"]
    assert len(rj) == len(rp) and len(rp) >= 20
    assert any(r.info["TYPE"] == "mnp" for r in rp)   # haplotype loci
    for a, b in zip(rp, rj):
        assert (a.chrom, a.pos, a.ref, a.alt, a.filter) == (
            b.chrom, b.pos, b.ref, b.alt, b.filter)
        for k in ("DP", "RO", "AO", "RPL", "RPR", "SAF", "SAR"):
            assert a.info[k] == b.info[k], (a.pos, k)
        assert abs(a.qual - b.qual) <= 0.0100001, (a.pos, a.qual, b.qual)
        for sa, sb in zip(a.samples, b.samples):
            for k in ("GT", "DP", "RO", "AO", "QR", "QA"):
                assert sa[k] == sb[k], (a.pos, k)
            assert abs(int(sa["GQ"]) - int(sb["GQ"])) <= 1
            gl_a = [float(x) for x in str(sa["GL"]).split(",")]
            gl_b = [float(x) for x in str(sb["GL"]).split(",")]
            assert np.allclose(gl_a, gl_b, atol=0.0100001, rtol=0), a.pos


def test_var_threads_and_windows(var_inputs, tmp_path):
    """-t 4 over a 4-window BED writes the same bytes as -t 1; the
    haplotype scan ran in those windows."""
    d, fa, bam, _ = var_inputs
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chrV\t{a}\t{a + 2500}\n"
                           for a in range(0, 10_000, 2500)))
    one = _port_cli(fa, bam, str(tmp_path / "t1"), "-w", str(bed))
    assert metrics.snapshot()["var.windows"] == 4
    four = _port_cli(fa, bam, str(tmp_path / "t4"), "-w", str(bed), "-t",
                     "4")
    assert metrics.snapshot()["var.hap_scan_lanes.cpu"] > 0
    with gzip.open(one, "rb") as a, gzip.open(four, "rb") as b:
        assert a.read() == b.read()


def test_genotype_batches_bound_the_program(var_inputs, tmp_path,
                                            monkeypatch):
    """With a cell budget of 1 every window is genotyped by its own
    program; the VCF does not change."""
    d, fa, bam, _ = var_inputs
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chrV\t{a}\t{a + 2500}\n"
                           for a in range(0, 10_000, 2500)))
    whole = _port_cli(fa, bam, str(tmp_path / "whole"), "-w", str(bed))
    assert metrics.snapshot()["var.genotype_programs.cpu"] == 1
    monkeypatch.setattr(tengine, "GENOTYPE_BATCH_CELLS", 1)
    split = _port_cli(fa, bam, str(tmp_path / "split"), "-w", str(bed))
    assert metrics.snapshot()["var.genotype_programs.cpu"] == 4
    with gzip.open(whole, "rb") as a, gzip.open(split, "rb") as b:
        assert a.read() == b.read()


def test_device_fault_fails_the_run(var_inputs, tmp_path, monkeypatch):
    """A failing haplotype scan raises out of run_var; a host-side window
    failure is contained (counted, no records for that window)."""
    d, fa, bam, _ = var_inputs
    import speedseq_tpu_torch.align.sw as tsw

    def boom(*a, **k):
        raise RuntimeError("device fault")

    with monkeypatch.context() as mp:
        mp.setattr(tsw, "banded_sw_score", boom)
        with pytest.raises(tcaller.DeviceError, match="device fault"):
            tengine.run_var(fa, [bam], str(tmp_path / "x.vcf.gz"),
                            device="cpu")
    real = tengine.build_pileup_columns
    bed = tmp_path / "w.bed"
    bed.write_text("chrV\t0\t5000\nchrV\t5000\t10000\n")

    def host_fault(cols, sids, start, end, **kw):
        if start == 0:
            raise ValueError("host fault")
        return real(cols, sids, start, end, **kw)

    monkeypatch.setattr(tengine, "build_pileup_columns", host_fault)
    out = _port_cli(fa, bam, str(tmp_path / "h"), "-w", str(bed))
    assert metrics.snapshot()["var.windows_failed"] == 1
    _, recs = read_vcf(out)
    assert recs and all(r.pos >= 5000 for r in recs)


def test_var_defaults_to_cuda(var_inputs, tmp_path, monkeypatch, capsys):
    d, fa, bam, _ = var_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.run_var(fa, [bam], str(tmp_path / "x.vcf.gz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["var", "-o", str(tmp_path / "y"), fa, bam])
    # --gff and -A are taken as the JAX CLI takes them: -A warns and the
    # run goes on (to the missing card here)
    for flag in (["--gff", "a.gff"], ["-A"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["var", *flag, fa, bam])
    assert "-A (Ensembl VEP) is not bundled" in capsys.readouterr().err
