"""The realign cell's generator, job runner and comparison, run on the
CPU at a tiny size through the port's CPU path (``--device cpu``): a
sound run comes out correct; the control, and the timed path broken
underneath in each way the cell can break, come out not correct."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import genome as gm
from benchmark import harness, sample
from benchmark.tests.test_bench_cells import patched
from benchmark.tests.tiny import tiny_copy

CELL = "germline-wgs30x-lanes.realign"
# the tiny size: the mix is not among tiny.py's, so it is cut here
PAIRS = 2000


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    bench = tiny_copy(str(d))
    p = os.path.join(bench, "traffic", "realign-lanes.json")
    with open(p) as fh:
        mix = json.load(fh)
    mix["pairs"] = PAIRS
    with open(p, "w") as fh:
        json.dump(mix, fh, indent=1)
    return harness.load_manifest(str(d)), bench


def _run(tiny, control=False, seed=11):
    m, bench = tiny
    return harness.run_cell(harness.Cell(m, CELL, bench), seed, 0.01, False,
                            "cpu", control=control)


def test_sound_run_is_correct(tiny):
    r = _run(tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"align_reads_per_s", "setup_s"}


def test_traffic_puts_duplicates_across_lanes_and_libraries(tiny):
    """Set-up's lanes: every library holds two lanes' pairs, some
    fragments repeat in one library across its lanes, and some in the
    other library (the twins)."""
    m, bench = tiny
    cell = harness.Cell(m, CELL, bench)
    ctx = harness.Context(cell, 7, "cpu", "")
    ctx.genome, _ = harness.reference_files(cell.config, os.path.join(
        bench, "cache"))
    job = cell.job
    parts = []
    g = ctx.genome
    for tid in range(len(g.contigs)):
        haps = [sample.identity(g.contigs[tid]), sample.germline(ctx, tid)]
        parts.append(sample.simulate(ctx, haps, tid, 4000, dup_rate=0.03))
    r = gm.concat_reads(parts, ctx.rng)
    lane = job.assign_lanes(ctx.rng, r, 2, 2, 0.03, 0.01)
    assert set(np.unique(lane)) == {0, 1, 2, 3}
    frag = {}
    for k in range(len(r.pos1)):
        frag.setdefault((int(r.tid[k]), int(r.pos1[k]), int(r.pos2[k]),
                         bool(r.rev1[k])), []).append(int(lane[k]))
    groups = [v for v in frag.values() if len(v) > 1]
    same_lib_other_lane = sum(len({x // 2 for x in v}) == 1
                              and len(set(v)) > 1 for v in groups)
    across_libs = sum(len({x // 2 for x in v}) > 1 for v in groups)
    copies = sum(len(v) - 1 for v in groups)
    assert same_lib_other_lane > 0 and across_libs > 0
    # about a third of the copies land in the other library
    assert 0.2 < across_libs / copies < 0.5
    assert job.read_groups(ctx)[2] == ("@RG\\tID:HG002.L3\\tSM:HG002"
                                       "\\tLB:HG002-lib2\\tPL:ILLUMINA")


def test_control_is_not_correct(tiny):
    r = _run(tiny, control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["dup_flag_errors"]["value"] > 0


def _inputs_unchanged():
    """The outputs left as the input lane BAMs: each file of the triple
    the lanes' records merged in coordinate order, their duplicate flags
    as each lane marked them alone."""
    from speedseq_tpu_torch.align import realign
    from speedseq_tpu_torch.formats import bai
    from speedseq_tpu_torch.formats.bam import read_bam, write_bam
    from speedseq_tpu_torch.formats.sam import SAMHeader

    def make(f):
        def merge(reference, bam_paths, out_prefix, *a, **k):
            outs = {}
            for suffix in (".bam", ".splitters.bam", ".discordants.bam"):
                recs, hdr = [], None
                for p in bam_paths:
                    h, r = read_bam(p[:-len(".bam")] + suffix)
                    hdr = hdr or h
                    recs += r
                recs.sort(key=lambda r: (r.tid < 0, r.tid, r.pos))
                out = out_prefix + suffix
                write_bam(out, SAMHeader.build(
                    refs=hdr.refs, read_groups=realign.merged_rg_lines(
                        bam_paths), sort_order="coordinate"), recs)
                bai.build_bai(out)
                outs[suffix[1:]] = out
            return outs
        return merge
    return patched(realign, "realign", make)


def _lib_map(key):
    from speedseq_tpu_torch.align import pipeline

    def make(f):
        def lib_map(rg_lines, cfg):
            out = f(rg_lines, cfg)
            ids = sorted(out)
            return {rg: key(ids.index(rg)) for rg in out}
        return lib_map
    return patched(pipeline, "_lib_map", make)


def _one_library():
    """One duplicate scope for every read group."""
    return _lib_map(lambda i: 0)


def _one_per_read_group():
    """A duplicate scope for each read group (each lane alone)."""
    return _lib_map(lambda i: i)


def _reverse_not_restored():
    """Reverse-strand records packed as stored, not turned back."""
    from speedseq_tpu_torch.align import realign
    from speedseq_tpu_torch.formats.sam import FREVERSE

    def make(f):
        def to_read(rec):
            rec.flag &= ~FREVERSE
            return f(rec)
        return to_read
    return patched(realign, "_record_to_read", make)


def _extract_fault(edit):
    from speedseq_tpu_torch.align import realign

    def make(f):
        def pairs(*a, **k):
            for i, (b1, b2) in enumerate(f(*a, **k)):
                got = edit(i, b1, b2)
                if got is not None:
                    yield got
        return pairs
    return patched(realign, "iter_bam_pairs", make)


def _rg_dropped():
    """The reads' read groups not carried through the batches."""
    def edit(i, b1, b2):
        for b in (b1, b2):
            if b is not None:
                b.comments = []
        return b1, b2
    return _extract_fault(edit)


def _half_left_out():
    """Every other batch of pairs left out of the job."""
    return _extract_fault(lambda i, b1, b2: (b1, b2) if i % 2 else None)


FAULTS = [_inputs_unchanged, _one_library, _one_per_read_group,
          _reverse_not_restored, _rg_dropped, _half_left_out]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(tiny, fault):
    """The faults planted under the window's jobs only: set-up aligns the
    lanes through the same CLI, so the lanes stay sound."""
    m, bench = tiny
    c = harness.Cell(m, CELL, bench)
    orig = c.job.run

    def run(ctx, k):
        with fault():
            return orig(ctx, k)
    c.job = type("Job", (), {})()
    for fn in ("setup", "discard", "check"):
        setattr(c.job, fn, getattr(harness.Cell(m, CELL, bench).job, fn))
    c.job.run = run
    r = harness.run_cell(c, 11, 0.01, False, "cpu")
    assert not r["correct"], r["checks"]
