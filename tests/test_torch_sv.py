"""The port's sv against the JAX package's, on the CPU.

- (a) the cluster sweep: ``cluster_scan_plain`` (and the CPU wrapper)
  integer-equal to ``_cluster_scan_jit`` on random sorted evidence, one
  row, one group and many one-row groups; per-cluster widths equal; a
  numpy model of the CUDA kernels (forced breaks from the packed int64
  max-scan, the piece walk, the tile offsets) equal to both on every
  sweep shape and on the inputs at the edges of the split;
- (b) ``cluster_breakpoints`` against the JAX device path on the random
  evidence of tests/test_sv.py:337-397: pos, CI, CI95, SU/PE/SR,
  sample_support and imprecise equal, PRPOS/PREND within atol 2e-5;
- (c) ``SVGenotyper.genotype_all`` against the JAX one on the unmapped-tail
  and depth-tier BAMs of tests/test_sv.py:457-568 and on the end-to-end
  calls: counts and GT equal, GQ within 1, SQ within 0.05, GL within 1;
- (d) depth bins, GC correction and the mean: equal; mean-shift on the
  abrupt-boundary fixture and on the end-to-end profile: the same CNV
  calls, partition values within rtol 1e-4;
- (e) end to end on a random 50 kbp genome carrying the DEL/INV/DUP of
  tests/test_sv.py:85-97, the BAM triple aligned once by the port on the
  CPU: the port's ``sv -g -d -P`` CLI against the JAX ``run_sv``.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from speedseq_tpu.formats.vcf import read_vcf as jread_vcf
from speedseq_tpu.sv import cluster as jcluster
from speedseq_tpu.sv import device as jdevice
from speedseq_tpu.sv.cnv import DepthProfile as JDepthProfile
from speedseq_tpu.sv.engine import SVConfig as JSVConfig
from speedseq_tpu.sv.engine import SVSample as JSVSample
from speedseq_tpu.sv.engine import extract_side_bams as jextract
from speedseq_tpu.sv.engine import run_sv as jax_run_sv
from speedseq_tpu.sv.evidence import InsertStats as JInsertStats
from speedseq_tpu.sv.svtyper import SVGenotyper as JSVGenotyper
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.bam import read_bam
from speedseq_tpu_torch.formats.fasta import decode_bases
from speedseq_tpu_torch.formats.vcf import read_vcf
from speedseq_tpu_torch.ops import sv_cluster
from speedseq_tpu_torch.sv import cluster as tcluster
from speedseq_tpu_torch.sv import device as tdevice
from speedseq_tpu_torch.sv import engine as tengine
from speedseq_tpu_torch.sv.cnv import DepthProfile
from speedseq_tpu_torch.sv.evidence import InsertStats, collect_evidence
from speedseq_tpu_torch.sv.svtyper import SVGenotyper
from speedseq_tpu_torch.utils import sim, sv_cases
from speedseq_tpu_torch.utils.metrics import metrics

COUNTS = ("dp", "ro", "ao", "rs", "as_", "rp", "ap", "gt", "ab")


# ------------------------------------------------------------ (a) the sweep

@pytest.mark.parametrize("shape", [s for s in sv_cases.SWEEP_SHAPES
                                   if not s.startswith("genome")])
def test_cluster_scan_matches_jax(shape):
    cols = sv_cases.sweep_columns(shape, seed=3)
    want = np.asarray(jdevice._cluster_scan_jit(*cols))
    t = [torch.from_numpy(c) for c in cols]
    plain = sv_cluster.cluster_scan_plain(*t)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(sv_cluster.cluster_scan(*t).numpy(), want)
    # per-cluster widths (the JAX package's _scan_extents_jit)
    n = len(cols[0])
    jx = np.asarray(jdevice._scan_extents_jit(*cols, n_seg=n))
    C = int(want[-1]) + 1
    for lo_c, hi_c, k in ((1, 2, 1), (3, 4, 2)):
        lo, hi = sv_cluster.cluster_extents(plain, t[lo_c], t[hi_c], C)
        np.testing.assert_array_equal((hi - lo).numpy(), jx[:C, k])


_M32 = 0xFFFFFFFF
_SWEEP_CASES = (list(sv_cases.SWEEP_SHAPES)
                + sorted(sv_cases.sweep_adversarial()))


def _sweep_case(name):
    if name in sv_cases.SWEEP_SHAPES:
        return sv_cases.sweep_columns(name, seed=3)
    return sv_cases.sweep_adversarial()[name]


def _sweep_model(gid, s1, e1, lo2, hi2, tile=sv_cluster.TILE_ROWS):
    """``csrc/sv_cluster.cu`` in numpy, tile by tile as its launches run:
    (ids, forced-break flags, the census of what the input reached).

    The packed keys (gid << 32) | (e1 ^ 0x80000000), their max per tile,
    the exclusive max-scan over tiles and within each tile (identity
    INT64_MIN) give each row the largest key before it; a row is a forced
    break when that key's gid differs or s1 >= its end1 (P).  Pieces
    between breaks are walked (all at once, by rank within the piece)
    with the serial overlap test; each tile's count of cluster starts,
    exclusively scanned, offsets the tile's inclusive scan of its flags."""
    i64 = np.int64
    g, s1, e1, lo2, hi2 = (np.asarray(c, i64) for c in (gid, s1, e1, lo2,
                                                        hi2))
    n = len(g)
    key = (g << 32) | ((e1 & _M32) ^ 0x80000000)
    none = np.iinfo(i64).min
    nb = -(-n // tile)
    padded = np.full(nb * tile, none, i64)
    padded[:n] = key
    tiles = padded.reshape(nb, tile)
    carry = np.maximum.accumulate(np.r_[none, tiles.max(1)[:-1]])
    within = np.maximum.accumulate(tiles, axis=1)
    prev = np.maximum(carry[:, None], np.c_[np.full(nb, none), within[:, :-1]]
                      ).reshape(-1)[:n]
    P = (prev & _M32) - 2**31
    brk = ((prev >> 32) != g) | (s1 >= P)
    starts = np.flatnonzero(brk)
    lens = np.diff(np.r_[starts, n])
    new = brk.copy()
    em, l2, h2 = e1[starts], lo2[starts], hi2[starts]
    for r in range(1, int(lens.max())):
        act = np.flatnonzero(lens > r)
        i = starts[act] + r
        ov = (s1[i] < em[act]) & (lo2[i] < h2[act]) & (hi2[i] > l2[act])
        em[act] = np.where(ov, np.maximum(em[act], e1[i]), e1[i])
        l2[act] = np.where(ov, np.minimum(l2[act], lo2[i]), lo2[i])
        h2[act] = np.where(ov, np.maximum(h2[act], hi2[i]), hi2[i])
        new[i] = ~ov
    flags = np.zeros(nb * tile, i64)
    flags[:n] = new
    per_tile = flags.reshape(nb, tile)
    offset = np.cumsum(per_tile.sum(1)) - per_tile.sum(1)
    ids = (offset[:, None] + np.cumsum(per_tile, 1) - 1).reshape(-1)[:n]
    same_gid = np.r_[False, g[1:] == g[:-1]]
    census = {
        "forced break at s1 == P": (brk & same_gid & (s1 == P)).any(),
        "tested at s1 == P - 1": (~brk & (s1 == P - 1)).any(),
        "piece of several clusters":
            (np.add.reduceat(new, starts) > 1).any() if n else False,
        "piece across a tile": ((starts // tile) != ((starts + lens - 1)
                                                       // tile)).any(),
        "single-row segment": (np.diff(np.flatnonzero(
            np.r_[True, ~same_gid[1:], True])) == 1).any(),
    }
    return ids.astype(np.int32), brk, census


@pytest.fixture(scope="module")
def sweep_wants():
    """Each sweep case's ids by the JAX scan and by the twin (computed
    once: the twin takes seconds at 1,048,576 rows)."""
    out = {}
    for name in _SWEEP_CASES:
        cols = _sweep_case(name)
        out[name] = (np.asarray(jdevice._cluster_scan_jit(*cols)),
                     sv_cluster.cluster_scan_plain(
                         *(torch.from_numpy(c) for c in cols)).numpy())
    return out


@pytest.mark.parametrize("case", _SWEEP_CASES)
def test_sweep_kernel_model(sweep_wants, case):
    """A numpy model of the sweep kernel's launches (forced breaks from
    the packed int64 max-scan, the piece walk, the tile offsets) equal to
    the twin and to ``_cluster_scan_jit`` on every sweep shape and the
    adversarial inputs, each of which reaches its edge."""
    cols = _sweep_case(case)
    ids, brk, census = _sweep_model(*cols)
    jax_ids, plain = sweep_wants[case]
    np.testing.assert_array_equal(plain, jax_ids)
    np.testing.assert_array_equal(ids, jax_ids)
    # every forced break starts a cluster in the reference
    assert (np.r_[True, jax_ids[1:] != jax_ids[:-1]][brk]).all()
    # small tiles put the carries and the pieces across tiles to work
    for t in (7, 1):
        small, _, c_small = _sweep_model(*cols, tile=t)
        np.testing.assert_array_equal(small, jax_ids)
    reach = {
        "gid change after a huge end1": ["single-row segment"],
        "end1 at both int32 limits": ["forced break at s1 == P",
                                      "piece of several clusters"],
        "s1 at P and one below": ["forced break at s1 == P",
                                  "tested at s1 == P - 1",
                                  "piece of several clusters"],
        "single-row segments": ["single-row segment"],
        "genome": ["piece across a tile"],
        "genome-piles": ["piece across a tile",
                         "piece of several clusters"],
    }.get(case, [])
    assert not [k for k in reach if not census[k]]
    if (np.diff(np.r_[np.flatnonzero(brk), len(brk)]) > 1).any():
        assert c_small["piece across a tile"]


# ------------------------------------------- (b) cluster_breakpoints on CPU

@pytest.mark.parametrize("seed,n,min_weight,trim", [
    (11, 200, 2, 0.0), (11, 200, 1, 0.0), (5, 60, 1, 0.01), (23, 400, 1, 0.0)])
def test_cluster_breakpoints_matches_jax(seed, n, min_weight, trim):
    ev = sv_cases.random_evidence(np.random.default_rng(seed), n)
    want = jcluster.cluster_breakpoints(ev, min_weight=min_weight, trim=trim)
    got = tcluster.cluster_breakpoints(ev, min_weight=min_weight, trim=trim,
                                       device="cpu")
    _assert_calls_match(got, want)


def test_cluster_breakpoints_deep_pile_matches_jax():
    """One cluster of 300 members: the member-rank loop's 300 steps sum
    in the reference's row order."""
    ev = sv_cases.pile_evidence(np.random.default_rng(41), 300)
    want = jcluster.cluster_breakpoints(ev, min_weight=4)
    got = tcluster.cluster_breakpoints(ev, min_weight=4, device="cpu")
    assert len(got) == 1 and got[0].su == 300
    _assert_calls_match(got, want)


def _assert_calls_match(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in ("svtype", "tid1", "strand1", "pos1", "tid2", "strand2",
                  "pos2", "cipos", "ciend", "cipos95", "ciend95", "su", "pe",
                  "sr", "sample_support", "imprecise"):
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        assert len(a.prpos) == len(b.prpos) and len(a.prend) == len(b.prend)
        np.testing.assert_allclose(a.prpos, b.prpos, atol=2e-5, rtol=0)
        np.testing.assert_allclose(a.prend, b.prend, atol=2e-5, rtol=0)


def test_host_combine_matches_jax():
    """The host statement of one cluster's combination, with and without
    the -r trim (tests/test_sv.py:286-295)."""
    p = np.array([0.001, 0.2, 0.6, 0.198, 0.001])
    items = [(100, p), (101, np.array([0.3, 0.5, 0.2]))]
    for trim in (0.0, 0.01):
        got = tcluster._combine(items, trim=trim)
        want = jcluster._combine(items, trim=trim)
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])


# ------------------------------------------------------- (c) the genotyper

def test_genotype_counts_matches_jax_and_host():
    """The program's count→GL step on every (ref, alt) up to 60: against
    the JAX float32 form GT equal, GQ within 1, SQ within 0.05, GL within
    1e-3; against the host float64 form GT equal, GQ within 1."""
    from speedseq_tpu_torch.sv.svtyper import genotype_from_counts

    ref, alt = (a.ravel().astype(np.int32)
                for a in np.meshgrid(np.arange(61), np.arange(61)))
    gl, gt, gq, sq, ab = (t.numpy() for t in tdevice.genotype_counts(
        torch.from_numpy(ref), torch.from_numpy(alt)))
    jgl, jgt, jgq, jsq, jab = (np.asarray(t) for t in
                               jdevice._genotype_counts(ref, alt))
    np.testing.assert_array_equal(gt, jgt)
    assert np.abs(gq - jgq).max() <= 1 and np.abs(sq - jsq).max() <= 0.05
    np.testing.assert_allclose(gl, jgl, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(ab, jab)
    for i in range(0, len(ref), 7):
        h = genotype_from_counts(int(ref[i]), int(alt[i]))
        assert h.gt == ("0/0", "0/1", "1/1")[gt[i]]
        assert abs(h.gq - int(gq[i])) <= 1



def _assert_genotypes_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in COUNTS:
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        assert abs(a.gq - b.gq) <= 1
        assert abs(a.sq - b.sq) <= 0.05
        assert np.abs(np.subtract(a.gl, b.gl)).max() <= 1


def _both_calls(fields):
    return ([tcluster.SVCall(**f) for f in fields],
            [jcluster.SVCall(**f) for f in fields])


@pytest.mark.parametrize("fixture", ["unmapped_tail_bam", "depth_tier_bam"])
def test_genotype_all_matches_jax(fixture, tmp_path, monkeypatch):
    bam = str(tmp_path / "t.bam")
    tcalls, jcalls = _both_calls(getattr(sv_cases, fixture)(bam))
    seen = []
    real = tdevice.svtyper_program

    def spy(a, b, R, *args, **kw):
        seen.append((len(a), R))
        return real(a, b, R, *args, **kw)

    monkeypatch.setattr(tdevice, "svtyper_program", spy)
    got = SVGenotyper(bam, InsertStats.synthetic(300, 50),
                      device="cpu").genotype_all(tcalls)
    jg = JSVGenotyper(bam, None, JInsertStats.synthetic(300, 50))
    want = jg.genotype_all(jcalls)
    jg.close()
    _assert_genotypes_match(got, want)
    assert got[0].dp > 0
    if fixture == "depth_tier_bam":   # the deep breakpoint runs alone
        (c_small, r_small), (c_big, r_big) = seen
        assert (c_small, c_big) == (8, 1) and r_big >= 4 * r_small
    else:
        assert len(seen) == 1


# --------------------------------------------------------------- (d) depth

def test_mean_shift_matches_jax():
    x, mean = sv_cases.abrupt_profile()
    want = jdevice.mean_shift_partition(x, mean)
    got = tdevice.mean_shift_partition(x, mean, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    prof = DepthProfile(bin_size=100, chroms=["c"], counts={"c": x},
                        corrected={"c": x}, mean=mean, device="cpu")
    dels = [c for c in prof.call("c") if c.kind == "deletion"]
    assert [(c.start, c.end) for c in dels] == [(15000, 25000)]


# ------------------------------------------------------------ (e) end to end

@pytest.fixture(scope="module")
def sv_inputs(tmp_path_factory):
    """A random 50 kbp genome, a haploid sample with the DEL/INV/DUP of
    tests/test_sv.py:85-97 at 30x of 100 bp pairs, aligned by the port on
    the CPU, and the JAX ``run_sv -g -d -P`` over that BAM triple."""
    d = tmp_path_factory.mktemp("tsv")
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 50_000).astype(np.uint8)
    events = [("DEL", 8000, 2500), ("INV", 25000, 2000), ("DUP", 35000, 1500)]
    mutant = sv_cases.apply_events(g, events, 0, len(g))
    fa = str(d / "sub.fa")
    s = decode_bases(g).decode()
    with open(fa, "w") as fh:
        fh.write(">sub\n" + "\n".join(s[i:i + 60]
                                      for i in range(0, len(s), 60)) + "\n")
    npairs = int(30 * len(mutant) / 200)
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(mutant, npairs,
                                                  read_len=100, seed=17)
    sim.to_fastq(str(d / "1.fq"), str(d / "2.fq"), names, s1, q1, s2, q2)
    align_fastq(fa, str(d / "1.fq"), str(d / "2.fq"), out_prefix=str(d / "s"),
                config=AlignConfig(batch_size=2048, sample="S1"),
                device="cpu")
    triple = [str(d / f"s.{k}") for k in ("bam", "splitters.bam",
                                          "discordants.bam")]
    want = jax_run_sv([JSVSample("S1", *triple)], str(d / "jax.sv.vcf.gz"),
                      JSVConfig(annotate_depth=True, reference=fa))
    return d, fa, triple, want, events


INFO_EQ = ("SVTYPE", "SVLEN", "END", "STRANDS", "CIPOS", "CIEND", "CIPOS95",
           "CIEND95", "SU", "PE", "SR", "IMPRECISE", "MATEID", "EVENT")
FMT_EQ = ("GT", "SU", "PE", "SR", "DP", "RO", "AO", "RS", "AS", "RP", "AP",
          "AB", "CN")


def _floats(v):
    return np.array([float(x) for x in str(v).split(",")])


def _assert_records_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.chrom, a.pos, a.id, a.alt) == (b.chrom, b.pos, b.id, b.alt)
        for k in INFO_EQ:
            assert a.info.get(k) == b.info.get(k), (a.pos, k)
        for k in ("PRPOS", "PREND"):
            x, y = _floats(a.info[k]), _floats(b.info[k])
            assert len(x) == len(y)
            np.testing.assert_allclose(x, y, atol=2e-5, rtol=1e-2)
        for sa, sb in zip(a.samples, b.samples):
            for k in FMT_EQ:
                assert sa.get(k) == sb.get(k), (a.pos, k)
            assert abs(int(sa["GQ"]) - int(sb["GQ"])) <= 1
            assert abs(float(sa["SQ"]) - float(sb["SQ"])) <= 0.05
            assert np.abs(_floats(sa["GL"]) - _floats(sb["GL"])).max() <= 1


def _readdepth(path):
    with open(path) as fh:
        rows = [l.split("\t") for l in fh.read().splitlines()]
    return [r[:4] for r in rows], np.array([float(r[4]) for r in rows])


def test_sv_end_to_end_matches_jax(sv_inputs):
    d, fa, (bam, spl, disc), want, events = sv_inputs
    metrics.reset()
    assert cli.main(["sv", "--device", "cpu", "-g", "-d", "-P", "-R", fa,
                     "-B", bam, "-S", spl, "-D", disc,
                     "-o", str(d / "port")]) == 0
    got = str(d / "port.sv.vcf.gz")
    snap = metrics.snapshot()
    for k in ("cluster_scans", "svtyper_programs", "depth_programs"):
        assert snap[f"sv.{k}.cpu"] >= 1, k
    assert os.path.exists(got + ".tbi")
    with gzip.open(got, "rt") as fh:
        assert fh.readline().startswith("##fileformat")
    hj, rj = jread_vcf(want)
    hp, rp = read_vcf(got)
    no_src = lambda lines: [l for l in lines if not l.startswith("##source")]
    assert no_src(hj.lines) == no_src(hp.lines)
    assert hp.samples == ["S1"]
    _assert_records_match(rp, rj)
    called = {r.info["SVTYPE"]: r for r in rp}
    for kind, p, ln in events:
        r = called[kind]
        assert abs(r.pos - p) <= 150 and abs(int(r.info["END"]) - (p + ln)) <= 150
    for suffix in ("txt", "bed"):
        kj, vj = _readdepth(str(d / f"jax.sv.S1.readdepth.{suffix}"))
        kp, vp = _readdepth(str(d / f"port.sv.S1.readdepth.{suffix}"))
        assert kp == kj and len(kp) >= 1
        np.testing.assert_allclose(vp, vj, rtol=1e-4, atol=0)


def test_sv_stages_match_jax(sv_inputs):
    """Genotyper and depth profile on the end-to-end BAM: the calls of the
    JAX clustering, genotyped by both packages; bins and GC correction
    equal; partitions within rtol 1e-4."""
    d, fa, (bam, spl, disc), _, _ = sv_inputs
    st = InsertStats.from_bam(bam)
    ev = collect_evidence([disc], [spl], [st])
    jst = JInsertStats.from_bam(bam)
    tcalls = tcluster.cluster_breakpoints(ev, device="cpu")
    jcalls = jcluster.cluster_breakpoints(ev)
    assert len(tcalls) == len(jcalls) >= 3
    got = SVGenotyper(bam, st, device="cpu").genotype_all(tcalls)
    jg = JSVGenotyper(bam, spl, jst)
    want = jg.genotype_all(jcalls)
    jg.close()
    _assert_genotypes_match(got, want)

    prof = DepthProfile.from_bam(bam, fa, device="cpu")
    jprof = JDepthProfile.from_bam(bam, fa)
    assert prof.mean == jprof.mean
    for c in jprof.chroms:
        np.testing.assert_array_equal(prof.counts[c], jprof.counts[c])
        np.testing.assert_array_equal(prof.corrected[c], jprof.corrected[c])
        np.testing.assert_allclose(prof.partition(c), jprof.partition(c),
                                   rtol=1e-4, atol=0)
    assert [(c.kind, c.start, c.end) for c in prof.call_all()] == [
        (c.kind, c.start, c.end) for c in jprof.call_all()]


def test_two_samples_threads_match_jax(sv_inputs, tmp_path):
    """Two samples (the same BAM triple under two names): -t 2 writes the
    bytes of -t 1, and the records of the JAX run_sv."""
    d, fa, triple, _, _ = sv_inputs
    names = ("S1", "S2")
    outs = {}
    for t in (1, 2):
        outs[t] = tengine.run_sv(
            [tengine.SVSample(n, *triple) for n in names],
            str(tmp_path / f"t{t}.sv.vcf.gz"),
            tengine.SVConfig(threads=t), device="cpu")
    with gzip.open(outs[1], "rb") as a, gzip.open(outs[2], "rb") as b:
        assert a.read() == b.read()
    want = jax_run_sv([JSVSample(n, *triple) for n in names],
                      str(tmp_path / "jax.sv.vcf.gz"), JSVConfig())
    hp, rp = read_vcf(outs[2])
    assert hp.samples == list(names)
    _assert_records_match(rp, jread_vcf(want)[1])


def test_extract_side_bams_matches_jax(sv_inputs, tmp_path):
    d, _, (bam, _, _), _, _ = sv_inputs
    outs = {}
    for name, fn in (("port", tengine.extract_side_bams), ("jax", jextract)):
        spl, disc = str(tmp_path / f"{name}.s.bam"), str(tmp_path / f"{name}.d.bam")
        fn(bam, spl, disc)
        outs[name] = [read_bam(p)[1] for p in (spl, disc)]
    for a, b in zip(outs["port"], outs["jax"]):
        assert len(a) == len(b) > 0
        assert all(x.qname == y.qname and x.flag == y.flag and x.pos == y.pos
                   for x, y in zip(a, b))


def test_sv_autogen_and_exclude(sv_inputs, tmp_path):
    """sv -B alone regenerates the side BAMs; an exclude BED over the DEL
    removes the DEL call; without -g the sample columns carry no GT."""
    import shutil

    d, _, (bam, _, _), _, events = sv_inputs
    full = str(tmp_path / "only.bam")
    shutil.copy(bam, full)
    xbed = str(tmp_path / "x.bed")
    with open(xbed, "w") as fh:
        fh.write(f"sub\t{events[0][1] - 1000}\t{events[0][1] + events[0][2] + 1000}\n")
    assert cli.main(["sv", "--device", "cpu", "-B", full, "-x", xbed,
                     "-o", str(tmp_path / "auto")]) == 0
    assert os.path.exists(full[:-4] + ".splitters.autogen.bam")
    assert os.path.exists(full[:-4] + ".discordants.autogen.bam")
    _, recs = read_vcf(str(tmp_path / "auto.sv.vcf.gz"))
    types = {r.info["SVTYPE"] for r in recs}
    assert "DEL" not in types and {"DUP", "INV"} <= types
    assert all(r.samples[0]["GT"] == "./." for r in recs)


def test_sv_defaults_to_cuda(sv_inputs, tmp_path, monkeypatch, capsys):
    d, fa, (bam, spl, disc), _, _ = sv_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    samples = [tengine.SVSample("S1", bam, spl, disc)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.run_sv(samples, str(tmp_path / "x.sv.vcf.gz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sv", "-B", bam, "-o", str(tmp_path / "y")])
    # --gff, -A and CRAM input are taken as the JAX CLI takes them: -A
    # warns and the run goes on (to the missing card here); a CRAM input
    # is not decoded before the device is resolved
    for flag in (["--gff", "a.gff"], ["-A"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["sv", *flag, "-B", bam])
    assert "-A (Ensembl VEP) is not bundled" in capsys.readouterr().err
    cram = tmp_path / "c.cram"
    cram.write_bytes(b"CRAM\x03\x00" + b"\x00" * 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.run_sv([tengine.SVSample("c", str(cram), spl, disc)],
                       str(tmp_path / "z.sv.vcf.gz"))
    assert not os.path.exists(str(cram) + ".decoded.bam")
