"""Each cell's generator, job runner and comparison, run on the CPU at a
tiny size through the port's CPU path (``--device cpu``): sound runs
come out correct; the control, and the timed path broken underneath in
each way the cell can break, come out not correct.  A CPU run reports no
device metric."""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_copy

CELLS = ["germline-wgs30x.align", "tumor-normal-wgs.somatic",
         "germline-wgs30x.var"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    bench = tiny_copy(str(d))
    return harness.load_manifest(str(d)), bench


def _run(tiny, cell, seed=11, trace=False, control=False):
    m, bench = tiny
    return harness.run_cell(harness.Cell(m, cell, bench), seed, 0.01, trace,
                            "cpu", control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {m["name"] for m in harness.Cell(
        tiny[0], cell, tiny[1]).end_to_end}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_host_layers_and_no_device_metric(tiny):
    r = _run(tiny, "germline-wgs30x.var", trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"var.pileup_s_per_mbp",
                                 "var.loci_s_per_mbp",
                                 "var.genotype_s_per_mbp",
                                 "setup.inputs_align_s"}
    assert r["device"]["busy_s"] == 0.0 and r["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    r = _run(tiny, cell, control=True)
    assert not r["correct"], r["checks"]


@contextlib.contextmanager
def patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _align_unchanged():
    from speedseq_tpu_torch.align import pipeline
    return patched(pipeline, "align_fastq", lambda f: lambda *a, **k: {})


def _align_half():
    from speedseq_tpu_torch.formats import extsort

    def make(f):
        def add(self, cols):
            return f(self, cols.subset(np.arange(0, cols.n, 2)))
        return add
    return patched(extsort.ExternalBAMSorter, "add_columns", make)


def _align_altered():
    from speedseq_tpu_torch.align import emit

    def make(f):
        def build(*a, **k):
            out = f(*a, **k)
            out["bam"].pos[::7] += 1
            return out
        return build
    return patched(emit, "build_batch_records", make)


def _var_unchanged():
    from speedseq_tpu_torch.formats import vcf
    return patched(vcf.VCFWriter, "write", lambda f: lambda self, rec: None)


def _var_half():
    from speedseq_tpu_torch.var import caller
    n = itertools.count()

    def make(f):
        def finish(*a, **k):
            out = f(*a, **k)
            return out if next(n) % 2 else []
        return finish
    return patched(caller, "finish_window", make)


def _var_altered():
    from speedseq_tpu_torch.var import engine

    def make(f):
        def to_vcf(*a, **k):
            rec = f(*a, **k)
            rec.samples[-1]["GL"][1] += 0.25
            return rec
        return to_vcf
    return patched(engine, "site_to_vcf", make)


def _qual_constant():
    """Genotype likelihoods from one quality for every base."""
    from speedseq_tpu_torch.var import caller

    def make(f):
        def build(*a, **k):
            locus = f(*a, **k)
            locus.quals = np.full_like(locus.quals, 37.0)
            return locus
        return build
    return patched(caller, "_build_simple_snv_locus", make)


def _qual_other_read():
    """Each covering read given its neighbour's base quality."""
    from speedseq_tpu_torch.var import pileup

    def make(f):
        def col(self, off):
            proj, qual, rpos = f(self, off)
            cov = proj >= 0
            qual[cov] = np.roll(qual[cov], 1)
            return proj, qual, rpos
        return col
    return patched(pileup.WindowPileup, "col", make)


def _qual_filter_dropped():
    """The minimum base quality not applied to the pileup."""
    from speedseq_tpu_torch.var import engine

    def make(f):
        def build(*a, **k):
            return f(*a, **dict(k, min_baseq=0))
        return build
    return patched(engine, "build_pileup_columns", make)


def _normal_ignored():
    """The somatic filter passes a record whatever the normal shows."""
    from speedseq_tpu_torch.var import somatic

    def make(f):
        def filt(cfg):
            fn = f(cfg)

            def decide(rec):
                kept = dict(rec.samples[0])
                rec.samples[0]["GT"] = "0/0"
                with patched(somatic, "ssc_score", lambda g: lambda *a: 99.0):
                    out = fn(rec)
                rec.samples[0].clear()
                rec.samples[0].update(kept)
                return out
            return decide
        return filt
    return patched(somatic, "somatic_filter", make)


VAR_FAULTS = [_var_unchanged, _var_half, _var_altered, _qual_constant,
              _qual_other_read, _qual_filter_dropped]
FAULTS = {
    "germline-wgs30x.align": [_align_unchanged, _align_half, _align_altered],
    "tumor-normal-wgs.somatic": VAR_FAULTS + [_normal_ignored],
    "germline-wgs30x.var": VAR_FAULTS,
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fs in FAULTS.items() for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_broken_timed_path_is_not_correct(tiny, cell, fault):
    """The faults planted under the window's jobs: a job that leaves its
    output as it was (nothing written), half of the work left out, an
    answer altered where it is produced, and for the callers the base
    qualities misread (one quality for all, a neighbour's, the minimum
    not applied), and for somatic the normal's genotype ignored by the
    filter.  One card: no exchange between chips to leave out."""
    if cell != "germline-wgs30x.align":
        # set-up aligns through the same CLI: break only the var path
        m, bench = tiny
        c = harness.Cell(m, cell, bench)
        orig = c.job.run

        def run(ctx, k):
            with fault():
                return orig(ctx, k)
        c.job = type("Job", (), {})()
        for fn in ("setup", "discard", "check"):
            setattr(c.job, fn, getattr(harness.Cell(m, cell, bench).job, fn))
        c.job.run = run
        r = harness.run_cell(c, 11, 0.01, False, "cpu")
    else:
        with fault():
            r = _run(tiny, cell)
    assert not r["correct"], r["checks"]
