"""The port's realign of a sample delivered as four lane BAMs of two
libraries, on the CPU, against the benchmark's plain reference
(``benchmark/reference/realign_check.py``, which reads the BAMs with its
own decoder):

- ``iter_bam_pairs`` gives the plain extraction's pairs in its order,
  with their names, SEQ, QUAL and RG, at batch sizes that cut the
  decode's chunks anywhere, with and without orphans;
- ``realign`` flags duplicates as samblaster does once per library:
  across the lanes of a library, never across libraries;
- the extract's spans and counters (``realign.extract.{decode,pair,
  pack}``, ``realign.{records,pairs,orphans,libraries}``) are in
  ``metrics.snapshot()``, the counts the plain extraction's.

The lanes: a random 3-contig genome, 176 pairs of 100 bp, a tenth of
them copied (the copy's reads equal to its original's) into the same
lane, another lane of the same library, or a lane of the other library;
each lane aligned alone by the port with its own read group, so its
duplicates are marked within the lane only."""

import numpy as np
import pytest
import torch

from benchmark.reference import realign_check as plain
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.align.realign import iter_bam_pairs, realign
from speedseq_tpu_torch.formats.bam import BAMReader, BAMWriter
from speedseq_tpu_torch.utils import synth
from speedseq_tpu_torch.utils.metrics import metrics

torch.set_num_threads(1)

RGS = [f"@RG\\tID:S.L{j + 1}\\tSM:S\\tLB:S-lib{j // 2 + 1}" for j in range(4)]
KINDS = ("same_lane", "other_lane", "other_library")
BATCH = 64
MAX_LEN = 151


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    d = tmp_path_factory.mktemp("lanes")
    g = synth.make_genome(seed=29)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 160, read_len=100, seed=31, kill_frac=0.0)
    rng = np.random.default_rng(37)
    n = len(rd.names)
    lane = list(rng.integers(0, 4, n))
    src = list(range(n))
    kind = [None] * n
    # copies of 16 pairs: lane ^ 0 the same lane, ^ 1 the library's other
    # lane, ^ 2 a lane of the other library
    for j, k in enumerate(rng.choice(n, 16, replace=False)):
        src.append(int(k))
        lane.append(lane[k] ^ (0, 1, 2)[j % 3])
        kind.append(KINDS[j % 3])
    src = np.asarray(src)
    names = [f"p{i:04d}" for i in range(len(src))]
    paths = []
    for j in range(4):
        sel = np.nonzero(np.asarray(lane) == j)[0]
        part = rd._replace(names=[names[i] for i in sel],
                           **{f: getattr(rd, f)[src[sel]] for f in (
                               "seq1", "qual1", "seq2", "qual2")})
        fq = (str(d / f"l{j}_1.fq"), str(d / f"l{j}_2.fq"))
        synth.write_fastq_pair(*fq, part)
        outs = align_fastq(fa, *fq, out_prefix=str(d / f"L{j + 1}"),
                           config=AlignConfig(batch_size=BATCH,
                                              rg_string=RGS[j]),
                           device="cpu")
        paths.append(outs["bam"])
    metrics.reset()
    out = realign(fa, paths, str(d / "re"),
                  config=AlignConfig(batch_size=BATCH), device="cpu")
    snap = metrics.snapshot()
    # the same lanes with read 2 of a few pairs gone: orphans
    odd = str(d / "odd.bam")
    with BAMReader(paths[0]) as rd0:
        gone = set(sorted({r.qname for r in rd0})[:10])
    with BAMReader(paths[0]) as rd0, BAMWriter(odd, rd0.header) as w:
        for r in rd0:
            if not (r.qname in gone and r.flag & 0x80):
                w.write(r)
    return {"fa": fa, "lanes": paths, "orphans": [odd] + paths[1:],
            "out": out, "snap": snap, "names": names, "kind": kind,
            "src": src}


def _port_pairs(paths, batch):
    got = []
    for b1, b2 in iter_bam_pairs(paths, None, batch, MAX_LEN):
        for i in range(b1.n):
            ends = []
            for b in (b1, b2):
                if b is None:
                    continue
                L = int(b.length[i])
                ends.append((b.seq[i, :L], b.qual[i, :L], b.comments[i]))
            got.append((b1.names[i], ends))
    return got


@pytest.mark.parametrize("batch", [5, BATCH, 1000])
@pytest.mark.parametrize("which", ["lanes", "orphans"])
def test_iter_bam_pairs_matches_plain_extraction(lanes, which, batch):
    paths = lanes[which]
    ext = plain.extract(paths)
    got = _port_pairs(paths, batch)
    pairs = [(nm, e) for nm, e in got if len(e) == 2]
    single = [(nm, e) for nm, e in got if len(e) == 1]
    assert [nm for nm, _ in pairs] == ext.names
    for (_, ends), want in zip(pairs, ext.ends):
        for (seq, qual, comment), (s, q, rg) in zip(ends, want):
            assert np.array_equal(seq, s) and np.array_equal(qual, q)
            assert comment == f"RG:{rg}"
    assert sorted(nm for nm, _ in single) == sorted(ext.orphans)
    assert bool(single) == (which == "orphans")


def _flags(lanes):
    """(flag of each pair, per-library rule, one-scope rule, lane) by
    pair name, from the output BAM and the plain extraction."""
    from benchmark.reference import bgzf

    main = bgzf.read_bam(lanes["out"]["bam"])
    ext = plain.extract(lanes["lanes"])
    ids = {nm: k for k, nm in enumerate(ext.names)}
    n = len(ids)
    i1 = np.full(n, -1, np.int64)
    i2 = np.full(n, -1, np.int64)
    for i, nm in enumerate(main.names):
        f = int(main.flag[i])
        if not f & 0x900:
            (i1 if f & 0x40 else i2)[ids[nm]] = i
    assert (i1 >= 0).all() and (i2 >= 0).all()
    lib_of = plain.libraries(plain.rg_lines(main.text))
    key = np.array([int(lib_of[e[0][2]][-1]) for e in ext.ends])
    order = np.arange(n)
    want, _ = plain.expected_duplicates(main, i1, i2, order, key)
    one, _ = plain.expected_duplicates(main, i1, i2, order, 0 * key)
    dup = (main.flag & 0x400) != 0
    got = dup[i1] | dup[i2]
    return ({nm: bool(got[k]) for nm, k in ids.items()},
            {nm: bool(want[k]) for nm, k in ids.items()},
            {nm: bool(one[k]) for nm, k in ids.items()},
            {nm: int(ext.lane[k]) for nm, k in ids.items()})


@pytest.mark.parametrize("kind", KINDS)
def test_realign_flags_duplicates_per_library(lanes, kind):
    """Every pair's flag is the per-library rule's; of each planted
    original and copy, the later in input order is flagged where both
    are in one library (one lane or two), and neither where the copy
    went to the other library."""
    got, want, one, lane = _flags(lanes)
    assert got == want
    names, src = lanes["names"], lanes["src"]
    planted = [(names[src[i]], names[i]) for i, k in enumerate(
        lanes["kind"]) if k == kind]
    assert planted
    for a, b in planted:
        if kind == "other_library":
            assert not got[a] and not got[b] and one[a] != one[b]
        else:
            assert got[a] != got[b]
            assert (lane[a] == lane[b]) == (kind == "same_lane")


def test_realign_extract_spans_and_counters(lanes):
    snap = lanes["snap"]
    ext = plain.extract(lanes["lanes"])
    parts = ("decode", "pair", "pack")
    for p in parts:
        assert snap[f"time.realign.extract.{p}"] > 0
        assert f"cpu.realign.extract.{p}" in snap
    total = sum(snap[f"time.realign.extract.{p}"] for p in parts)
    assert 0.5 * snap["time.realign.extract"] <= total \
        <= snap["time.realign.extract"] + 1e-3
    assert snap["realign.records"] == ext.records
    assert snap["realign.pairs"] == len(ext.names)
    assert snap.get("realign.orphans", 0) == len(ext.orphans) == 0
    assert snap["realign.libraries"] == 2


def test_extract_counts_orphans(lanes):
    ext = plain.extract(lanes["orphans"])
    metrics.reset()
    for _ in iter_bam_pairs(lanes["orphans"], None, BATCH, MAX_LEN):
        pass
    snap = metrics.snapshot()
    assert len(ext.orphans) == 10
    assert snap["realign.orphans"] == len(ext.orphans)
    assert snap["realign.records"] == ext.records
    assert snap["realign.pairs"] == len(ext.names)
