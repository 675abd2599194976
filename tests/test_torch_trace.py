"""The port's spans (``utils/metrics.py``): the align path's dispatch,
waits, close, index load and the device step's five stages, the
epilogue's parts, var's window spans and counters, and the benchmark's
readers of the align metrics, on the CPU over a random 6 kbp genome.
Spans enter a profiler range (``_RecordFunctionFast``) only while a
profiler records, and then nest under ``ssq.align.dispatch``."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from speedseq_tpu_torch import cli
from speedseq_tpu_torch.utils import sim, somatic_cases
from speedseq_tpu_torch.utils.metrics import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("seed_chain", "select", "extend", "rescue_xa", "pack")
ALIGN_SPANS = (
    ["align.index_load", "align.index_load.read", "align.index_load.kmer",
     "align.index_load.to_device", "align.input_wait", "align.dispatch",
     "align.drain_wait", "align.close", "align.emit", "align.emit.markdup",
     "align.emit.side"]
    + [f"align.stage.{s}" for s in STAGES])
VAR_SPANS = ["var.pileup", "var.fetch", "var.decode", "var.columns",
             "var.loci", "var.loci.atoms", "var.loci.hap", "var.loci.compact",
             "var.hap_scan"]
VAR_COUNTERS = ["var.fetch_bytes", "var.atoms", "var.loci.snv",
                "var.loci.indel", "var.loci.hap", "var.hap_groups",
                "var.hap_cands"]
RG = "@RG\\tID:1\\tSM:s1"


def _align(d, fa, fq1, fq2, prefix):
    assert cli.main(["align", "--device", "cpu", "--batch-size", "64", "-R",
                     RG, "-o", str(d / prefix), fa, fq1, fq2]) == 0
    return str(d / prefix) + ".bam"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A random 6 kbp genome, a diploid sample with SNVs, indels and SNV
    pairs 1-2 bp apart (so var scores haplotypes), 16x of 100 bp pairs;
    aligned once with the profiler range made to raise and counted, no
    profiler recording."""
    d = tmp_path_factory.mktemp("ttrace")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 6_000).astype(np.uint8)
    fa = str(d / "g.fa")
    somatic_cases.write_fasta(fa, "chrT", g)
    hap, variants, coord = sim.mutate(g, rng, snv_rate=0.003,
                                      indel_rate=0.0005)
    taken = np.array([p for p, _, _ in variants] or [-100])
    for i, pos in enumerate(range(300, 5700, 600)):
        h = np.searchsorted(coord, pos)
        gap = 1 + i % 2
        if np.abs(taken - pos).min() > 12 and coord[h + gap] == pos + gap:
            for k in (h, h + gap):
                hap[k] = (hap[k] + 1) % 4
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(
        g, 480, read_len=100, seed=9, diploid_genome=hap, coord_map=coord)
    sim.to_fastq(str(d / "r1.fq"), str(d / "r2.fq"), names, s1, q1, s2, q2)
    # one batch, for the profiled run
    sim.to_fastq(str(d / "s1.fq"), str(d / "s2.fq"), names[:64],
                 s1[:64], q1[:64], s2[:64], q2[:64])

    entered = []

    def refuse(*a, **k):
        entered.append(a)
        raise AssertionError("profiler range entered with no profiler")

    prof = torch._C._profiler
    real = prof._RecordFunctionFast
    prof._RecordFunctionFast = refuse
    try:
        metrics.reset()
        bam = _align(d, fa, str(d / "r1.fq"), str(d / "r2.fq"), "plain")
        snap = metrics.snapshot()
    finally:
        prof._RecordFunctionFast = real
    return (d, fa), bam, snap, entered


def test_align_snapshot_holds_every_span(world):
    _, _, snap, _ = world
    for name in ALIGN_SPANS:
        assert f"time.{name}" in snap and f"cpu.{name}" in snap, name
    # the stages nest in the dispatch on one thread
    stages = sum(snap[f"time.align.stage.{s}"] for s in STAGES)
    assert 0 < stages <= snap["time.align.dispatch"] + 1e-3
    parts = sum(snap[f"time.align.emit.{p}"] for p in ("markdup", "side"))
    assert parts <= snap["time.align.emit"] + 1e-3
    kids = sum(snap[f"time.align.index_load.{p}"]
               for p in ("read", "kmer", "to_device"))
    assert kids <= snap["time.align.index_load"] + 1e-3
    for k, v in snap.items():
        if k.startswith("cpu."):
            assert v <= snap["time." + k[4:]] + 1e-3, k
    # stream spans only on the card
    assert not any(k.endswith(".stream_s") for k in snap)
    assert "align.device_step_s" not in snap


def test_no_profiler_range_without_a_profiler(world):
    _, bam, _, entered = world
    assert os.path.exists(bam) and entered == []


def test_spans_nest_under_dispatch_in_a_profile(world, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    used = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name):
        used.append(name)
        return real(name)

    (d, fa), _, _, _ = world
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _align(d, fa, str(d / "s1.fq"), str(d / "s2.fq"), "profiled")
    assert "ssq.align.dispatch" in used
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ssq."):
            # an op range: no user annotation to mirror onto a device
            assert not e.is_user_annotation(), e.name()
            a = e.start_ns()
            spans.append((e.name(), a, a + e.duration_ns(),
                          e.start_thread_id()))
    dispatch = [s for s in spans if s[0] == "ssq.align.dispatch"]
    stages = [s for s in spans if s[0].startswith("ssq.align.stage.")]
    assert dispatch and {s[0] for s in stages} == {
        f"ssq.align.stage.{s}" for s in STAGES}
    for name, a, b, th in stages:
        outer = [d for d in dispatch if d[3] == th and d[1] <= a
                 and b <= d[2]]
        assert len(outer) == 1, (name, a, b)
    # the profiler records the thread that started it: the dispatching
    # one (the index was loaded in this process before: no k-mer build)
    assert {s[0] for s in spans} >= {
        "ssq.align.index_load", "ssq.align.index_load.to_device",
        "ssq.align.input_wait", "ssq.align.drain_wait", "ssq.align.close"}


def test_var_spans_and_counters(world, capsys):
    (d, fa), bam, _, _ = world
    metrics.reset()
    assert cli.main(["var", "--device", "cpu", "-v", "-o", str(d / "v"), fa,
                     bam]) == 0
    snap = metrics.snapshot()
    # -v prints the registry
    printed = dict(line[len("[var] "):].split(": ", 1)
                   for line in capsys.readouterr().out.splitlines()
                   if line.startswith("[var] ") and ": " in line
                   and not line.endswith(" sites"))
    for name in VAR_COUNTERS:
        assert float(printed[name]) == pytest.approx(snap[name]), name
    for name in VAR_SPANS:
        assert f"time.{name}" in printed and f"cpu.{name}" in printed, name
    for name in VAR_SPANS:
        assert f"time.{name}" in snap and f"cpu.{name}" in snap, name
    for name in VAR_COUNTERS:
        assert snap.get(name, 0) > 0, name
    assert snap["var.sites"] > 0
    assert (snap["var.loci.snv"] + snap["var.loci.indel"]
            + snap["var.loci.hap"]) >= snap["var.sites"]
    pile = sum(snap[f"time.var.{p}"] for p in ("fetch", "decode", "columns"))
    assert pile <= snap["time.var.pileup"] + 1e-3
    loci = sum(snap[f"time.var.loci.{p}"] for p in ("atoms", "hap",
                                                    "compact"))
    assert loci <= snap["time.var.loci"] + 1e-3
    assert snap["time.var.hap_scan"] <= snap["time.var.loci.hap"] + 1e-3


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(on_card, snap=None, warm=None):
    return type("Run", (), {"snap": snap or {}, "warm": warm or {},
                            "units": 4000, "on_card": on_card})()


@pytest.mark.parametrize("name,key", [
    ("align.dispatch_ms_per_kread", "time.align.dispatch"),
    ("align.dispatch_cpu_ms_per_kread", "cpu.align.dispatch"),
    ("align.input_wait_ms_per_kread", "time.align.input_wait"),
    ("align.drain_wait_ms_per_kread", "time.align.drain_wait"),
    ("align.close_ms_per_kread", "time.align.close"),
] + [(f"align.stage.{s}_ms_per_kread", f"align.stage.{s}.stream_s")
     for s in STAGES])
def test_align_metric_readers(name, key):
    r = _reader(name)
    # 0.5 s over 4,000 reads: 125 ms a thousand reads
    assert r.read(_run(True, {key: 0.5})) == pytest.approx(125.0)
    assert r.read(_run(True, {})) is None
    host = r.read(_run(False, {key: 0.5}))
    if ".stage." in name:
        assert host is None
    else:
        assert host == pytest.approx(125.0)


def test_kmer_index_reader():
    r = _reader("setup.kmer_index_s")
    assert r.read(_run(True, warm={"time.align.index_load.kmer": 1.5})) \
        == 1.5
    assert r.read(_run(True)) is None
