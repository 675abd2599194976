"""The port's realign, bamkit utilities, CRAM input and CLI surface, on the
CPU.

- (a) ``realign`` against the JAX ``realign`` on a BAM that the port
  aligned from a random 3-contig genome, at batch 60 (not a multiple of
  the 8 virtual CPU devices, so the JAX run stays on one device; its
  Pallas kernels in interpret mode, as tests/test_torch_align.py runs
  them): the BAM triple record-equal, headers equal apart from @PG;
- (b) the orphan case of tests/test_aux.py:125-155: every input primary
  read survives;
- (c) the RG library grouping of tests/test_aux.py:158-161;
- (d) the merged header (port only: the JAX realign reads the first BAM's
  @RG lines alone): two BAMs with different @RG IDs give both lines, and
  every output RG tag is declared;
- (e) ``filter_read_groups`` / ``group_reads_by_name`` as
  tests/test_aux.py:377-418;
- (f) ``formats/cram.py`` is the JAX package's decoder (the same code up
  to imports and docstrings), and an sv input that starts with the CRAM
  magic routes through ``cram_to_bam`` (monkeypatched to copy a BAM) and
  writes the records of the BAM run;
- (g) the CLI answers ``--help`` for all five subcommands; ``--seed-mode
  fm`` is the one thing refused.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import speedseq_tpu.align.pipeline as jpipe
import speedseq_tpu.ops.sw_pallas as spl
from speedseq_tpu.align.realign import realign as jax_realign
from speedseq_tpu.formats.bam import read_bam as jread_bam
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align.realign import (
    clean_rg_lines, merged_rg_lines, read_groups_by_library, realign)
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.bam import BAMReader, BAMWriter, read_bam, write_bam
from speedseq_tpu_torch.formats.sam import SAMHeader, SAMRecord
from speedseq_tpu_torch.formats.vcf import read_vcf
from speedseq_tpu_torch.sv import engine as tengine
from speedseq_tpu_torch.utils import synth
from speedseq_tpu_torch.utils.metrics import metrics

from nm_recount import Genome, assert_record_equal, no_kernel_nm

# One torch thread per pytest worker process, as tests/test_torch_somatic.py
# explains (the port's CPU path spins against other workers otherwise).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 60
OUTS = ("bam", "splitters.bam", "discordants.bam")
RG = "@RG\\tID:rg9\\tSM:NA\\tLB:L9"


def _prim(recs):
    return {(r.qname, r.flag & 0xC0): (r.tid, r.pos) for r in recs
            if not r.flag & 0x900}


@pytest.fixture(scope="module")
def realign_inputs(tmp_path_factory):
    """A random 3-contig genome with planted deletions and a duplicated
    segment, 360 pairs of 100 bp aligned by the port on the CPU (read
    group rg9, library L9)."""
    d = tmp_path_factory.mktemp("trealign")
    g = synth.make_genome(seed=11, n_del=12)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 360, read_len=100, seed=17, kill_frac=0.0)
    synth.write_fastq_pair(str(d / "r1.fq"), str(d / "r2.fq"), rd)
    outs = align_fastq(fa, str(d / "r1.fq"), str(d / "r2.fq"),
                       out_prefix=str(d / "orig"),
                       config=AlignConfig(batch_size=128, rg_string=RG),
                       device="cpu")
    return d, fa, outs


@pytest.fixture(scope="module")
def both_realigns(realign_inputs):
    d, fa, outs = realign_inputs
    metrics.reset()
    port = realign(fa, [outs["bam"]], str(d / "port"),
                   config=AlignConfig(batch_size=BATCH), device="cpu")
    snap = metrics.snapshot()
    mp = pytest.MonkeyPatch()
    oc, os_ = spl.sw_pallas_cigar, spl.sw_pallas
    mp.setattr(spl, "sw_pallas_cigar", no_kernel_nm(oc))
    mp.setattr(spl, "sw_pallas",
               lambda *a, interpret=False, **k: os_(*a, interpret=True, **k))
    mp.setattr(jpipe, "_pallas_ok", lambda: True)
    try:
        ref = jax_realign(fa, [outs["bam"]], str(d / "jax"),
                          config=jpipe.AlignConfig(batch_size=BATCH))
    finally:
        mp.undo()
    return ref, port, snap


def _no_pg(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.mark.parametrize("out", OUTS)
def test_realign_triple_matches_jax(both_realigns, realign_inputs, out):
    """Record-equal, NM as tests/nm_recount.py holds it."""
    ref, port, _ = both_realigns
    genome = Genome(realign_inputs[1])
    hj, rj = jread_bam(ref[out])
    hp, rp = jread_bam(port[out])
    assert _no_pg(hj.text) == _no_pg(hp.text)
    assert len(rj) == len(rp) and (out != "bam" or len(rp) >= 720)
    for a, b in zip(rj, rp):
        assert_record_equal(a, b, genome)
    assert os.path.exists(port[out] + ".bai")


def test_realign_keeps_placements_and_read_groups(realign_inputs,
                                                  both_realigns):
    """≥ 98 % of primary placements unchanged (tests/test_aux.py:117), the
    read group carried through, the extract timer and the mate-wait
    counter set."""
    _, _, outs = realign_inputs
    _, port, snap = both_realigns
    _, orig = read_bam(outs["bam"])
    hdr, recs = read_bam(port["bam"])
    a, b = _prim(orig), _prim(recs)
    assert set(a) == set(b)
    assert sum(b[k] == a[k] for k in a) / len(a) >= 0.98
    assert [l for l in hdr.text.splitlines() if l.startswith("@RG")] == [
        RG.replace("\\t", "\t")]
    assert all(r.get_tag("RG") == "rg9" for r in recs)
    assert snap["time.realign.extract"] > 0
    assert 1 <= snap["realign.pending_peak"] <= 720


def test_realign_orphan_reads_not_dropped(realign_inputs, tmp_path):
    """Pairs whose read 2 is missing realign their read 1 single-end."""
    d, fa, outs = realign_inputs
    hdr, recs = read_bam(outs["bam"])
    prim = [r for r in recs if not r.flag & 0x900 and r.seq != "*"]
    drop_r2 = set(sorted({r.qname for r in prim})[:7])
    odd = str(tmp_path / "odd.bam")
    with BAMReader(outs["bam"]) as rd, BAMWriter(odd, rd.header) as w:
        for r in rd:
            if not (r.qname in drop_r2 and r.flag & 0x80):
                w.write(r)
    routs = realign(fa, [odd], str(tmp_path / "re"),
                    config=AlignConfig(batch_size=BATCH), device="cpu")
    _, re_recs = read_bam(routs["bam"])
    out_keys = {(r.qname, r.flag & 0xC0) for r in re_recs
                if not r.flag & 0x900}
    want = {(r.qname, r.flag & 0xC0) for r in prim
            if not (r.qname in drop_r2 and r.flag & 0x80)}
    # the orphans come back single-end (no read-1/read-2 bits)
    assert len(out_keys) == len(want)
    assert {q for q, _ in out_keys} == {q for q, _ in want}
    single = [r for r in re_recs if r.qname in drop_r2]
    assert single and all(not r.flag & 0x1 for r in single)


def test_rg_library_grouping():
    txt = "@RG\tID:a\tSM:s\tLB:l1\n@RG\tID:b\tSM:s\tLB:l1\n@RG\tID:c\tSM:s\tLB:l2"
    assert read_groups_by_library(txt) == {"l1": ["a", "b"], "l2": ["c"]}
    assert clean_rg_lines("@HD\tVN:1.6\n" + txt) == txt.split("\n")


def test_realign_merges_read_groups_of_all_inputs(realign_inputs, tmp_path):
    """Two BAMs with different @RG IDs (the second shares one): the output
    header declares each ID once, in first-seen order, and every RG tag in
    the output is declared."""
    d, fa, outs = realign_inputs
    hdr, recs = read_bam(outs["bam"])
    names = sorted({r.qname for r in recs})
    second = set(names[len(names) // 2:])
    lines = {"rg9": RG.replace("\\t", "\t"),
             "rgB": "@RG\tID:rgB\tSM:NB\tLB:LB2"}

    def part(path, keep, rg_ids):
        h = SAMHeader.build(refs=hdr.refs,
                            read_groups=[lines[i] for i in rg_ids])
        rows = []
        for r in recs:
            if (r.qname in second) != keep:
                continue
            if keep:
                r.tags = [t for t in r.tags if t[0] != "RG"] + [
                    ("RG", "Z", "rgB")]
            rows.append(r)
        write_bam(path, h, rows)

    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    part(a, False, ["rg9"])
    part(b, True, ["rgB", "rg9"])
    routs = realign(fa, [a, b], str(tmp_path / "m"),
                    config=AlignConfig(batch_size=BATCH), device="cpu")
    h2, out = read_bam(routs["bam"])
    rg_lines = [l for l in h2.text.splitlines() if l.startswith("@RG")]
    assert rg_lines == [lines["rg9"], lines["rgB"]]
    tags = {r.get_tag("RG") for r in out}
    assert tags == {"rg9", "rgB"}
    assert all((r.get_tag("RG") == "rgB") == (r.qname in second)
               for r in out)
    assert merged_rg_lines([a, b]) == rg_lines


def test_realign_defaults_to_cuda(realign_inputs, tmp_path, monkeypatch):
    d, fa, outs = realign_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        realign(fa, [outs["bam"]], str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["realign", "-o", str(tmp_path / "y"), fa, outs["bam"]])


# --------------------------------------------------------------- (e) bamutil

def test_bamutil_filter_and_group(tmp_path):
    from speedseq_tpu_torch.formats.bamutil import (
        filter_read_groups, group_reads_by_name)

    hdr = SAMHeader.build(refs=[("c1", 5000)],
                          read_groups=["@RG\tID:a\tSM:s1", "@RG\tID:b\tSM:s2"])
    recs = []
    for i, (name, rg) in enumerate([("r10", "a"), ("r2", "b"), ("r2", "b"),
                                    ("r1", "a"), ("r10", "a")]):
        flag = 0x40 if i % 2 == 0 else 0x80
        recs.append(SAMRecord(
            qname=name, flag=flag | 1, tid=0, pos=100 * i, mapq=40,
            cigar=[(0, 50)], mtid=-1, mpos=-1, tlen=0, seq="A" * 50,
            qual="I" * 50, tags=[("RG", "Z", rg)]))
    src = str(tmp_path / "u.bam")
    write_bam(src, hdr, recs)
    out = str(tmp_path / "rg_a.bam")
    assert filter_read_groups(src, out, ["a"]) == 3
    h2, r2 = read_bam(out)
    assert all(r.get_tag("RG") == "a" for r in r2)
    assert "ID:b" not in h2.text and "ID:a" in h2.text
    gout = str(tmp_path / "grouped.bam")
    group_reads_by_name(src, gout)
    _, r3 = read_bam(gout)
    # natural-number order: r1 < r2 < r10; read 1 before read 2 in a name
    assert [r.qname for r in r3] == ["r1", "r2", "r2", "r10", "r10"]
    fl = [(r.qname, bool(r.flag & 0x40)) for r in r3]
    assert fl[1] == ("r2", True) and fl[2] == ("r2", False)


# ------------------------------------------------------------------ (f) CRAM

def _code_of(path):
    """The module's AST without docstrings and import statements."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(body, list):
            node.body = [n for n in node.body
                         if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return tree


_GATE = ast.dump(ast.parse("native.available()", mode="eval").body)


def _native_path_only(tree):
    """The original with each ``if native.available():`` branch in place of
    itself and the fallback after it: the port requires the native runtime
    and keeps only that path."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        for i, n in enumerate(body if isinstance(body, list) else []):
            if isinstance(n, ast.If) and ast.dump(n.test) == _GATE:
                node.body = body[:i] + n.body
                break
    return tree


@pytest.mark.parametrize("rel", ["formats/cram.py", "formats/bamutil.py",
                                 "var/annotate.py"])
def test_copied_modules_equal_their_originals(rel):
    port = _code_of(os.path.join(ROOT, "speedseq_tpu_torch", rel))
    orig = _native_path_only(_code_of(os.path.join(ROOT, "speedseq_tpu", rel)))
    assert ast.dump(port) == ast.dump(orig)


def test_sv_cram_input_routes_through_cram_to_bam(realign_inputs, tmp_path,
                                                  monkeypatch):
    from speedseq_tpu_torch.formats import cram

    d, fa, outs = realign_inputs
    spl, disc = outs["splitters.bam"], outs["discordants.bam"]
    cfg = tengine.SVConfig(min_weight=2, reference=fa)
    want = tengine.run_sv([tengine.SVSample("NA", outs["bam"], spl, disc)],
                          str(tmp_path / "bam.sv.vcf.gz"), cfg, device="cpu")
    fake = str(tmp_path / "in.cram")
    with open(fake, "wb") as fh:
        fh.write(cram.CRAM_MAGIC + b"\x03\x00" + b"\x00" * 20)
    calls = []

    def to_bam(src, dst, reference=None):
        calls.append((src, dst, reference))
        shutil.copy(outs["bam"], dst)
        return dst

    monkeypatch.setattr(cram, "cram_to_bam", to_bam)
    got = tengine.run_sv([tengine.SVSample("NA", fake, spl, disc)],
                         str(tmp_path / "cram.sv.vcf.gz"), cfg, device="cpu")
    assert calls == [(fake, fake + ".decoded.bam", fa)]
    _, rw = read_vcf(want)
    _, rg = read_vcf(got)
    assert len(rw) >= 1 and [r.to_line() for r in rg] == [
        r.to_line() for r in rw]


# ------------------------------------------------------------------- (g) CLI

def test_cli_help_and_dispatch():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "speedseq_tpu_torch",
                          "--help"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0
    for sub in ("align", "realign", "var", "somatic", "sv"):
        assert sub in out.stdout
        with pytest.raises(SystemExit) as e:
            cli.main([sub, "--help"])
        assert e.value.code == 0
    # align requires -R (reference contract: "required")
    assert cli.main(["align", "x.fa", "y.fq"]) == 1


@pytest.mark.parametrize("sub", ["align", "realign"])
def test_cli_refuses_fm_seeding(sub, capsys, monkeypatch):
    """FM seeding is ported: ``--seed-mode fm`` is no longer refused (exit
    2); the CLI hands it to the aligner in its config."""
    import speedseq_tpu_torch.align.pipeline as tp
    import speedseq_tpu_torch.align.realign as tr

    seen = {}

    def fake(*a, config=None, **k):
        seen["seed_mode"] = config.seed_mode
        return {"bam": "x.bam"}

    monkeypatch.setattr(tp, "align_fastq", fake)
    monkeypatch.setattr(tr, "realign", fake)
    args = [sub, "--seed-mode", "fm", "-R", "@RG\\tID:a\\tSM:b", "-o", "x",
            "ref.fa", "in"]
    assert cli.main(args) == 0
    assert seen == {"seed_mode": "fm"}
    assert "not ported" not in capsys.readouterr().err
