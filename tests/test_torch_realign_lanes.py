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
  ``metrics.snapshot()``, the counts the plain extraction's;
- the columnar stream: equal to the plain extraction with its chunk cut
  to one BGZF block and to a size that cuts records across chunk edges
  (lanes re-written in small BGZF blocks), each inflate a part of its
  file (one block at a chunk of one byte), and no SAMRecord decoded; on records of every edge
  (qualities all 0xff, IUPAC and ``=`` codes, reads longer than
  ``max_len``, secondary, supplementary and sequence-less records, no RG,
  the ``rg_ids`` filter) its batches equal the per-record extraction's
  (``_per_record_batches``: SAMRecords through ``BAMReader``); with
  reverse-strand rows left unturned it fails the plain comparison.

The lanes: a random 3-contig genome, 176 pairs of 100 bp, a tenth of
them copied (the copy's reads equal to its original's) into the same
lane, another lane of the same library, or a lane of the other library;
each lane aligned alone by the port with its own read group, so its
duplicates are marked within the lane only."""

import numpy as np
import pytest
import torch

from benchmark.reference import realign_check as plain
from speedseq_tpu_torch import native
from speedseq_tpu_torch.align import realign as realign_mod
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.align.realign import iter_bam_pairs, realign
from speedseq_tpu_torch.formats import bam as bam_mod
from speedseq_tpu_torch.formats import bgzf
from speedseq_tpu_torch.formats.bam import BAMReader, BAMWriter
from speedseq_tpu_torch.formats.fasta import encode_bases
from speedseq_tpu_torch.formats.sam import SAMHeader, SAMRecord
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


# --- the columnar stream ---------------------------------------------------

SMALL_BLOCK = 1000     # payload bytes of the re-written lanes' BGZF blocks


def _reblock(src: str, dst: str, payload: int = SMALL_BLOCK) -> None:
    """``src`` re-written in BGZF blocks of ``payload`` inflated bytes, so
    records straddle many block edges."""
    with open(src, "rb") as fh:
        raw = bgzf.decompress(fh.read())
    with open(dst, "wb") as fh:
        for i in range(0, len(raw), payload):
            fh.write(bgzf._compress_block(raw[i:i + payload]))
        fh.write(bgzf.BGZF_EOF)


@pytest.fixture(scope="module")
def small_blocks(lanes, tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    out = {}
    for which in ("lanes", "orphans"):
        out[which] = []
        for j, p in enumerate(lanes[which]):
            q = str(d / f"{which}{j}.bam")
            _reblock(p, q)
            out[which].append(q)
    return out


def _plain_diffs(paths, batch):
    """Pairs, ends and orphans in which ``iter_bam_pairs`` differs from
    the plain extraction."""
    ext = plain.extract(paths)
    got = _port_pairs(paths, batch)
    pairs = [(nm, e) for nm, e in got if len(e) == 2]
    single = sorted(nm for nm, e in got if len(e) == 1)
    bad = abs(len(pairs) - len(ext.names)) + len(
        set(single) ^ set(ext.orphans))
    for (nm, ends), want_nm, want in zip(pairs, ext.names, ext.ends):
        bad += nm != want_nm
        for (seq, qual, comment), (s, q, rg) in zip(ends, want):
            bad += not (np.array_equal(seq, s) and np.array_equal(qual, q)
                        and comment == f"RG:{rg}")
    return bad


@pytest.mark.parametrize("which", ["lanes", "orphans"])
@pytest.mark.parametrize("chunk", [1, 3000])
def test_extract_matches_plain_at_chunk_edges(small_blocks, monkeypatch,
                                              which, chunk):
    """Chunk 1: every inflate is one block (a read of a byte at a time
    completes one block at most); 3000 B: several blocks, records cut at
    the chunk's end.  Either way an inflate holds a part of its file:
    memory follows the chunk."""
    monkeypatch.setattr(realign_mod, "CHUNK_BYTES", chunk)
    sizes = []
    inflate = native.bgzf_decompress

    def counted(data, nthreads=None):
        out = inflate(data, nthreads)
        sizes.append(len(out))
        return out
    monkeypatch.setattr(native, "bgzf_decompress", counted)
    metrics.reset()
    assert _plain_diffs(small_blocks[which], 7) == 0
    snap = metrics.snapshot()
    paths = small_blocks[which]
    assert snap["realign.extract.chunks"] == len(sizes) > 2 * len(paths)
    assert snap["realign.extract.inflated_bytes"] == sum(sizes)
    per_file = sum(sizes) / len(paths)
    assert max(sizes) <= (SMALL_BLOCK if chunk == 1 else per_file / 2)
    assert SMALL_BLOCK < per_file / 4


@pytest.mark.parametrize("which", ["lanes", "orphans"])
def test_extract_decodes_no_samrecord(lanes, monkeypatch, which):
    def no_record(buf):
        raise AssertionError("per-record decode on the extract's path")
    monkeypatch.setattr(bam_mod, "decode_record", no_record)
    assert _plain_diffs(lanes[which], BATCH) == 0


def test_unturned_reverse_rows_fail_the_plain_comparison(lanes, monkeypatch):
    """The planted fault: the orient step leaves reverse-strand rows as
    stored."""
    assert _plain_diffs(lanes["lanes"], BATCH) == 0
    monkeypatch.setattr(realign_mod, "_TURN", 0)
    assert _plain_diffs(lanes["lanes"], BATCH) > 0


def _per_record_batches(paths, rg_ids, batch, max_len, rename):
    """The extraction a SAMRecord at a time (``BAMReader``,
    ``decode_record``), as the columnar stream replaced it: each batch as
    (names, [ends of read 1], [ends of read 2] or None), an end (seq,
    qual, comment)."""
    def end(rec):
        seq = encode_bases(rec.seq.encode())
        qual = (np.full(len(seq), 30, np.uint8) if rec.qual == "*" else
                np.frombuffer(rec.qual.encode(), np.uint8) - 33)
        if rec.flag & 0x10:
            seq = np.where(seq[::-1] < 4, 3 - seq[::-1], 4).astype(np.uint8)
            qual = qual[::-1]
        return seq[:max_len], qual[:max_len], f"RG:{rec.get_tag('RG') or ''}"

    pending, ready = {}, []
    for path in paths:
        with BAMReader(path) as rd:
            for rec in rd:
                if rec.flag & 0x900 or rec.seq in ("*", ""):
                    continue
                if rg_ids is not None and (
                        rec.get_tag("RG") or "") not in rg_ids:
                    continue
                mate = pending.pop(rec.qname, None)
                if mate is None:
                    pending[rec.qname] = rec
                else:
                    ready.append((rec.qname, *((rec, mate) if rec.flag & 0x40
                                               else (mate, rec))))
    out, k = [], 0
    groups = [ready[i:i + batch] for i in range(0, len(ready), batch)] + [
        [(q, r, None) for q, r in list(pending.items())[i:i + batch]]
        for i in range(0, len(pending), batch)]
    for g in groups:
        names = [f"r{k + i}" if rename else q for i, (q, _, _) in
                 enumerate(g)]
        k += len(g)
        out.append((names, [end(a) for _, a, _ in g],
                    None if g[0][2] is None else [end(b) for _, _, b in g]))
    return out


def _edge_lanes(d, rng):
    """Two BAMs of mates in random order (a pair's ends in either BAM):
    bases mostly ACGT with IUPAC codes, ``=`` and lower case; lengths 1 to
    220; a tenth with qualities ``*``; read groups A, B or none; secondary
    and supplementary copies, records without a sequence, and orphans."""
    hdr = SAMHeader(text="@HD\tVN:1.6\n@SQ\tSN:c1\tLN:5000\n"
                         "@RG\tID:A\tSM:s\n@RG\tID:B\tSM:s\n",
                    refs=[("c1", 5000)])
    letters = np.array(list("ACGT" * 6 + "NRYKMSWBDHV=acgtn"))
    recs = []

    def rec(name, flag, rg):
        n = int(rng.integers(1, 221))
        seq = "".join(rng.choice(letters, n))
        qual = "*" if rng.random() < 0.1 else "".join(
            chr(33 + int(q)) for q in rng.integers(0, 61, n))
        tags = [("NM", "i", 0)] + ([("RG", "Z", rg)] if rg else [])
        return SAMRecord(name, flag, 0, int(rng.integers(0, 4000)), 60,
                         [(0, n)], 0, 0, 0, seq, qual, tags)

    for i in range(300):
        rg = ["A", "B", None][int(rng.integers(0, 3))]
        for first in (True, False):
            if i % 37 == 5 and not first:      # an orphan
                continue
            flag = 0x1 | (0x40 if first else 0x80) | (
                0x10 if rng.random() < 0.5 else 0)
            recs.append(rec(f"q{i}", flag, rg))
            if rng.random() < 0.06:
                recs.append(rec(f"q{i}", flag | 0x100, rg))
            if rng.random() < 0.04:
                recs.append(rec(f"q{i}", flag | 0x800, rg))
            if rng.random() < 0.03:
                r = rec(f"q{i}", flag, rg)
                r.seq, r.qual = "*", "*"
                recs.append(r)
    order = rng.permutation(len(recs))
    paths = []
    for j in range(2):
        p, q = str(d / f"edge{j}.bam"), str(d / f"edge{j}.small.bam")
        with BAMWriter(p, hdr) as w:
            for k in order[j::2]:
                w.write(recs[k])
        _reblock(p, q)
        paths.append(q)
    return paths


@pytest.fixture(scope="module")
def edge_lanes(tmp_path_factory):
    return _edge_lanes(tmp_path_factory.mktemp("edge"),
                       np.random.default_rng(43))


@pytest.mark.parametrize("rg_ids,max_len,batch,rename", [
    (None, 151, 7, False), (None, 40, 64, True), ({"A"}, 151, 5, False),
    ({"B", ""}, 151, 64, False), ({"A", "B"}, 97, 1000, True),
    (set(), 151, 7, False)])
def test_extract_edge_records_equal_per_record(edge_lanes, monkeypatch,
                                               rg_ids, max_len, batch,
                                               rename):
    monkeypatch.setattr(realign_mod, "CHUNK_BYTES", 700)
    want = _per_record_batches(edge_lanes, rg_ids, batch, max_len, rename)
    got = list(iter_bam_pairs(edge_lanes, rg_ids, batch, max_len,
                              rename=rename))
    assert len(got) == len(want) and (rg_ids == set() or want)
    for (b1, b2), (names, e1, e2) in zip(got, want):
        assert (b2 is None) == (e2 is None)
        for b, ends in ((b1, e1), (b2, e2)):
            if b is None:
                continue
            assert b.names == names
            assert b.seq.shape == b.qual.shape == (len(names), max_len)
            assert b.seq.dtype == b.qual.dtype == np.uint8
            assert b.length.dtype == np.int32
            assert b.comments == [c for _, _, c in ends]
            for i, (s, q, _) in enumerate(ends):
                L = int(b.length[i])
                assert L == len(s)
                assert np.array_equal(b.seq[i, :L], s)
                assert np.array_equal(b.qual[i, :L], q)
                assert (b.seq[i, L:] == 4).all() and (b.qual[i, L:] == 0).all()
