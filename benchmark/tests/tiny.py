"""A copy of the benchmark at a tiny size, for the CPU tests: the same
files, with a 110 kbp reference and jobs of a few thousand reads, and
the var cell, which ``BENCHMARK.json`` leaves out while its rate spreads
too widely on the card's host, so that its job kind and mix stay sound
for the cell that brings them back."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

CONTIGS = [["chr1", 60000], ["chr2", 30000], ["chr3", 20000]]
TRAFFIC = {
    "align-fastq": {"pairs": 2000},
    "somatic-region": {"region": {"contig": "chr1", "start": 5000,
                                  "end": 45000},
                       "window_bp": 10000, "normal_pairs": 4000,
                       "tumor_pairs": 8000},
    "var-region": {"region": {"contig": "chr2", "start": 2000,
                              "end": 22000},
                   "window_bp": 5000, "pairs": 2000},
}

# a cell kept out of the manifest, with the per-layer metrics it reads
# from the cell whose layers it shares
SHELVED = [({"name": "germline-wgs30x.var", "config": "germline-wgs30x",
             "traffic": "var-region", "chips": 1,
             "why": "var -t 1 jobs over one region at 30x"},
            "tumor-normal-wgs.somatic")]


def tiny_copy(dest: str) -> str:
    """``dest``/benchmark and ``dest``/BENCHMARK.json at the tiny size;
    returns the copy's benchmark directory."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "cache", "__pycache__", "tests"))
    for f in os.listdir(os.path.join(bench, "configs")):
        p = os.path.join(bench, "configs", f)
        cfg = json.load(open(p))
        cfg["reference"]["contigs"] = CONTIGS
        json.dump(cfg, open(p, "w"), indent=1)
    for mix, over in TRAFFIC.items():
        p = os.path.join(bench, "traffic", mix + ".json")
        t = json.load(open(p))
        t.update(over)
        json.dump(t, open(p, "w"), indent=1)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    for cell, like in SHELVED:
        m["workloads"].append(cell)
        for e in m["end_to_end"] + m["per_layer"]:
            if like in e.get("workloads", ()):
                e["workloads"].append(cell["name"])
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(m, fh, indent=1)
    return bench
