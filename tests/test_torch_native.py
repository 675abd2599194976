"""The port's native host runtime is required, and one module decides it:
every host entry point that calls it raises the loader's RuntimeError,
with the compiler's message, when the library does not build, and leaves
no output behind as if written; a working build after a failed one loads
in the same process once the loader's state is reset.

The failing build is real: g++ compiles a source whose only line is an
``#error`` carrying a known marker, into a build directory of the test's
own."""

import os

import numpy as np
import pytest

from speedseq_tpu_torch import native
from speedseq_tpu_torch.align import realign
from speedseq_tpu_torch.align.emit import RecordColumns
from speedseq_tpu_torch.formats import bai, bgzf
from speedseq_tpu_torch.formats.bam import BAMWriter
from speedseq_tpu_torch.formats.bam_cols import records_to_columns
from speedseq_tpu_torch.formats.extsort import ExternalBAMSorter
from speedseq_tpu_torch.formats.sam import SAMHeader, SAMRecord
from speedseq_tpu_torch.sv.evidence import InsertStats, collect_evidence
from speedseq_tpu_torch.var.engine import run_var
from speedseq_tpu_torch.var.pileup import build_pileup_columns

MARK = "ssq-native-test-marker"
G_LEN, PAIRS, RL = 4000, 40, 50


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 4 kbp contig, its FASTA, and 40 proper pairs on it as SAMRecords
    and as a coordinate-sorted BAM (written while the runtime works)."""
    d = tmp_path_factory.mktemp("native_world")
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, G_LEN))
    fa = str(d / "g.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + genome + "\n")
    header = SAMHeader(
        text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{G_LEN}\n"
             "@RG\tID:1\tSM:s1\n", refs=[("chr1", G_LEN)])
    recs = []
    for i in range(PAIRS):
        p1, p2 = 100 + 60 * i, 350 + 60 * i
        for j, (pos, mpos, flag) in enumerate(((p1, p2, 0x63),
                                               (p2, p1, 0x93))):
            recs.append(SAMRecord(
                qname=f"p{i}", flag=flag, tid=0, pos=pos, mapq=60,
                cigar=[(0, RL)], mtid=0, mpos=mpos,
                tlen=(p2 + RL - p1) * (1 if j == 0 else -1),
                seq=genome[pos:pos + RL], qual="I" * RL,
                tags=[("RG", "Z", "1")]))
    recs.sort(key=lambda r: r.pos)
    bam = str(d / "in.bam")
    with BAMWriter(bam, header) as w:
        w.write_batch(recs)
    return dict(fa=fa, header=header, recs=recs, bam=bam)


def _fail_build(monkeypatch, tmp_path):
    """Reset the loader and point its build at a source g++ refuses."""
    src = tmp_path / "broken.cc"
    src.write_text(f"#error {MARK}\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_build_dir",
                        lambda: str(tmp_path / "native_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)


def _record_columns(recs):
    c = records_to_columns(recs)
    return RecordColumns(n=c.n, **{k: getattr(c, k)
                                   for k in native.BamColumns.__slots__})


# Each case: (world, out directory) -> the call that must raise.  What a
# case needs from the runtime is made before the loader is broken.

def _encode(w, out):
    cols = _record_columns(w["recs"])
    return cols.encode


def _compress(w, out):
    return lambda: bgzf.compress(b"ACGT" * 20_000)


def _build_bai(w, out):
    bam = os.path.join(out, "a.bam")
    with open(w["bam"], "rb") as src, open(bam, "wb") as dst:
        dst.write(src.read())
    return lambda: bai.build_bai(bam)


def _sort_close(w, out):
    s = ExternalBAMSorter(os.path.join(out, "sorted.bam"), w["header"],
                          max_records=16)
    cols = _record_columns(w["recs"])
    for lo in range(0, cols.n, 20):
        s.add_columns(cols.subset(np.arange(lo, min(lo + 20, cols.n))))
    assert s.state()["chunks"]               # the sort spilled
    return s.close


def _pileup(w, out):
    cols = native.bam_decode(_record_columns(w["recs"]).encode())
    sids = np.zeros(cols.n, np.int32)
    return lambda: build_pileup_columns(cols, sids, 0, G_LEN)


def _evidence(w, out):
    st = InsertStats.synthetic(300.0, 30.0, RL)
    return lambda: collect_evidence([w["bam"]], [w["bam"]], [st])


def _bam_pairs(w, out):
    return lambda: list(realign.iter_bam_pairs([w["bam"]], None, 16, 151))


def _var(w, out):
    bam = os.path.join(out, "v.bam")
    with open(w["bam"], "rb") as src, open(bam, "wb") as dst:
        dst.write(src.read())
    bai.build_bai(bam)
    # the multi-process part stream: a plain file, written even when
    # every window failed
    return lambda: run_var(w["fa"], [bam], os.path.join(out, "v.vcf.gz"),
                           device="cpu", _shard=(1, 0),
                           _part_out=os.path.join(out, "v.part"))


CASES = {
    "RecordColumns.encode": _encode,
    "bgzf.compress": _compress,
    "bai.build_bai": _build_bai,
    "ExternalBAMSorter.close-spilled": _sort_close,
    "build_pileup_columns": _pileup,
    "collect_evidence": _evidence,
    "iter_bam_pairs": _bam_pairs,
    "run_var": _var,
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("case", list(CASES))
def test_failed_build_raises_at_first_use(world, tmp_path, monkeypatch,
                                          case):
    out = tmp_path / "out"
    out.mkdir()
    call = CASES[case](world, str(out))
    before = _files(out)
    _fail_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match=MARK) as e:
        call()
    assert "g++" in str(e.value)
    assert _files(out) == before             # no output left as if written


def test_working_build_after_a_failed_one(tmp_path, monkeypatch):
    """The failure is remembered (a fixed source does not build again
    until the state is reset); after the reset the real library loads in
    this process and compresses as before."""
    data = b"ACGT" * 20_000
    want = bgzf.compress(data)
    src, build_dir = native._SRC, native._build_dir
    _fail_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match=MARK) as first:
        bgzf.compress(data)
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_build_dir", build_dir)
    with pytest.raises(RuntimeError) as again:
        bgzf.compress(data)
    assert str(again.value) == str(first.value)
    monkeypatch.setattr(native, "_error", None)
    assert bgzf.compress(data) == want
    assert bgzf.decompress(want) == data
