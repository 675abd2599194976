"""One run of one cell: set-up, a closed loop of whole CLI jobs through
``speedseq_tpu_torch.cli.main`` for the window, the traced stretch when
asked, the plain reference's judgement of a job drawn from the seed,
and the result line.

Everything that belongs to one configuration, traffic mix, job kind or
per-layer metric lives in files of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``job`` names
``jobs/<job>.py``) and ``metrics/<metric>.py``.  A new cell needs new
files and new entries in ``BENCHMARK.json``, never an edit here."""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "speedseq_tpu")


def seed_words(seed: int, stream: int) -> List[int]:
    """Entropy for ``np.random.default_rng``: the seed's two 32-bit words
    and the number of the stream drawn from it."""
    seed %= 1 << 64
    return [seed & 0xFFFFFFFF, seed >> 32, stream]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


class Cell:
    """A workload of the manifest with its configuration, traffic mix,
    job kind and per-layer readers, found by name under ``bench_dir``."""

    def __init__(self, manifest: dict, name: str, bench_dir: str = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.spec = cells[name]
        self.name = name
        self.bench_dir = bench_dir
        conf = {c["name"]: c for c in manifest["configs"]}[self.spec["config"]]
        with open(os.path.join(os.path.dirname(bench_dir),
                               conf["file"])) as fh:
            self.config = json.load(fh)
        with open(os.path.join(bench_dir, "traffic",
                               self.spec["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)
        self.job = load_module(os.path.join(
            bench_dir, "jobs", self.traffic["job"] + ".py"),
            "bench_job_" + self.traffic["job"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m["workloads"]]
        self.readers = {m["name"]: load_module(os.path.join(
            bench_dir, "metrics", m["name"] + ".py"),
            "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            for m in self.per_layer}


class Context:
    """What a job kind gets: the cell's parameters, the seed's random
    stream, the reference files, the work directory and the device.  A
    job's set-up records the seconds of its named steps in ``spans``."""

    def __init__(self, cell: Cell, seed: int, device: str, work: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.rng = np.random.default_rng(seed_words(seed, 1))
        self.check_rng = np.random.default_rng(seed_words(seed, 3))
        self.device = device
        self.work = work
        self.genome = None
        self.fasta = None
        self.spans: Dict[str, float] = {}

    def cli(self, argv: List[str]) -> int:
        from speedseq_tpu_torch import cli

        return cli.main([argv[0], "--device", self.device] + argv[1:])


def reference_files(config: dict, cache: str):
    """The configuration's reference genome and its bwa index in
    ``<cache>/ref-<recipe hash>/``: built on the first run in a checkout,
    read on the others."""
    from benchmark import genome as gm

    recipe = config["reference"]
    g = gm.make_reference(recipe)
    d = os.path.join(cache, "ref-" + gm.recipe_key(recipe))
    fa = os.path.join(d, "ref.fa")
    if not os.path.exists(fa + ".bwt"):
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        gm.write_fasta(os.path.join(tmp, "ref.fa"), g)
        from speedseq_tpu_torch.index.bwt import build_index

        build_index(os.path.join(tmp, "ref.fa"))
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
    return g, fa


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """Run one cell once and return the result line's object."""
    import torch

    from speedseq_tpu_torch.utils.metrics import metrics

    t_start = time.perf_counter() if t_start is None else t_start
    work = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"bench-{cell.name}-{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ctx = Context(cell, seed, device, work)
        ctx.genome, ctx.fasta = reference_files(
            cell.config, os.path.join(cell.bench_dir, "cache"))
        cell.job.setup(ctx)
        for k, v in ctx.spans.items():
            print(f"benchmark: set-up {k} {v:.3f} s", file=sys.stderr)
        metrics.reset()
        warm = cell.job.run(ctx, "warm")
        _sync(device)
        warm_snap = metrics.snapshot()
        cell.job.discard(ctx, "warm")
        setup_s = time.perf_counter() - t_start
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()

        metrics.reset()
        jobs, traced = [], None
        t0 = time.perf_counter()
        while True:
            k = len(jobs)
            if trace and k == 0:
                traced = _traced_job(ctx, k)
                jobs.append(traced["job"])
                before = metrics.snapshot()
            else:
                jobs.append(cell.job.run(ctx, k))
            _sync(device)
            print(f"benchmark: job {k} ends at "
                  f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        snap = metrics.snapshot()
        peak = (torch.cuda.max_memory_allocated() if device.startswith(
            "cuda") else 0)

        failed = sum(not j["ok"] for j in jobs)
        units = sum(j["units"] for j in jobs)
        result = {"correct": False, "attempted": len(jobs), "failed": failed}
        if trace:
            untraced = jobs[1:]
            if untraced:
                host = {k: v - before.get(k, 0.0) for k, v in snap.items()}
                host_units = sum(j["units"] for j in untraced)
            else:
                host, host_units = snap, units
            run = Reading(host, host_units, warm_snap, ctx.spans, traced,
                          device)
            vals = {}
            for m in cell.per_layer:
                v = cell.readers[m["name"]].read(run)
                if v is not None:
                    vals[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = vals
        else:
            vals = {}
            for m in cell.end_to_end:
                if m["name"] == "setup_s":
                    vals["setup_s"] = {"value": setup_s, "unit": "s"}
                else:
                    vals[m["name"]] = {"value": units / elapsed,
                                       "unit": m["unit"]}
            result["metrics"] = vals
        result["device"] = device_info(device, peak, traced)
        if trace:
            result["breakdown"] = traced["trace"].breakdown()
            traced = None
        del warm
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()

        # the plain reference judges one job drawn from the seed
        pick = int(np.random.default_rng(seed_words(seed, 2)).integers(
            0, len(jobs)))
        limits = cell.traffic["limits"]
        try:
            checks = cell.job.check(ctx, pick, control=control)
        except (OSError, ValueError, KeyError, IndexError) as e:
            # outputs that are missing or cannot be read are wrong ones
            print(f"benchmark: job {pick}'s outputs unreadable: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            checks = {k: None for k in limits}
        for line in checks.pop("details", None) or ():
            print(f"benchmark: {line}", file=sys.stderr)
        result["correct"] = failed == 0 and all(
            checks[k] is not None and checks[k] <= limits[k]
            for k in limits)
        result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                            for k in limits}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _traced_job(ctx: Context, k: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as tr

    launches: Dict[str, list] = {}
    acts = [ProfilerActivity.CPU]
    if ctx.device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with tr.instrumented(launches):
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(tr.SPAN_PREFIX + "job"):
                job = ctx.cell.job.run(ctx, k)
                _sync(ctx.device)
    return {"job": job, "trace": tr.Trace(prof, "job"),
            "launches": launches}


class Reading:
    """What a per-layer reader reads: the window's host timers and
    counters (``snap``) over ``units`` of work, the warm job's
    (``warm``), the set-up's named steps (``setup``, seconds), and the
    traced job's device trace and launches."""

    def __init__(self, snap, units, warm, setup, traced, device):
        self.snap = snap
        self.units = units
        self.warm = warm
        self.setup = setup
        self.trace = traced["trace"]
        self.launches = traced["launches"]
        self.job_units = traced["job"]["units"]
        self.on_card = device.startswith("cuda")
        self.clock_hz, self.n_sms = clock_and_sms() if self.on_card else (
            None, None)


def clock_and_sms():
    import subprocess

    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True, timeout=30)
    return (float(out.stdout.strip().splitlines()[0]) * 1e6,
            torch.cuda.get_device_properties(0).multi_processor_count)


def device_info(device: str, peak: int, traced) -> dict:
    import torch

    if device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if traced is not None:
        info["busy_s"] = traced["trace"].busy_s
        info["window_s"] = traced["trace"].window_s
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
