"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name: configurations, traffic mixes, job kinds and
per-layer readers whose layer, unit and moved metric agree with it."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
M = harness.load_manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_names_and_limits():
    assert set(M) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in
                                             p for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert not any(w.startswith("/") for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    for sect in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[sect]]
        assert len(names) == len(set(names))
        for e in M[sect]:
            optional = {"workloads"} if sect == "end_to_end" else set()
            extra = set(e) - KEYS[sect] - optional
            assert KEYS[sect] <= set(e) and not extra, (sect, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in M["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(M["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in M["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", cells))
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    # the whole check fits its budget with 24 cells
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.Cell(M, cell)
    assert c.config["name"] == c.spec["config"]
    conf = {x["name"]: x for x in M["configs"]}[c.spec["config"]]
    for k in conf["reduced"]:
        assert k in c.config["reduced"] and k in c.config
    for fn in ("setup", "run", "discard", "check"):
        assert callable(getattr(c.job, fn))
    assert set(c.traffic["limits"]) and all(
        v >= 0 for v in c.traffic["limits"].values())
    got = {m["name"] for m in c.end_to_end}
    assert "setup_s" in got and len(got) >= 2 and c.per_layer
    for m in c.per_layer:
        r = c.readers[m["name"]]
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"])
        assert m["moves"] in got


def test_config_sources_match_their_files():
    for c in M["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            f = json.load(fh)
        assert f["source"] == c["source"] and f["name"] == c["name"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as new files and new manifest entries in a copy, are found by the
    harness's discovery with no edit to a file that was there."""
    import shutil

    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "germline-wgs30x.json").read_text())
    cfg["name"] = "throwaway"
    (bench / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "var-region.json").read_text())
    mix["region"]["contig"] = "chr3"
    (bench / "traffic" / "var-chr3.json").write_text(json.dumps(mix))
    (bench / "metrics" / "var.sites_per_mbp.py").write_text(
        'LAYER = "var loci"\nUNIT = "sites/Mbp"\nMOVES = "call_mbp_per_s"\n'
        "\n\ndef read(run):\n    n = run.snap.get('var.sites')\n"
        "    return None if n is None else n / run.units\n")
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "throwaway", "source": "x", "why": "x",
                         "file": "benchmark/configs/throwaway.json",
                         "reduced": ["genome_bp"]})
    m["workloads"].append({"name": "throwaway.var-chr3", "config":
                           "throwaway", "traffic": "var-chr3", "chips": 1,
                           "why": "x"})
    for e in m["end_to_end"]:
        if e["name"] == "call_mbp_per_s":
            e["workloads"].append("throwaway.var-chr3")
    m["per_layer"].append({"name": "var.sites_per_mbp", "unit":
                           "sites/Mbp", "better": "higher", "source":
                           "program_counter", "layer": "var loci",
                           "moves": "call_mbp_per_s",
                           "workloads": ["throwaway.var-chr3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    c = harness.Cell(harness.load_manifest(str(tmp_path)),
                     "throwaway.var-chr3", str(bench))
    assert c.traffic["region"]["contig"] == "chr3"
    assert "var.sites_per_mbp" in c.readers
    assert c.readers["var.sites_per_mbp"].read(type(
        "R", (), {"snap": {"var.sites": 30.0}, "units": 2.0})()) == 15.0
    assert {m["name"] for m in c.end_to_end} == {"call_mbp_per_s",
                                                 "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
