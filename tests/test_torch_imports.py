"""The port stands alone: it imports with jax unavailable, imports nothing
of jax or speedseq_tpu (nor does chip_smoke.py), runs a tiny CPU align in
that state, and refuses to fall back to the CPU when CUDA is asked for."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "speedseq_tpu_torch")

NO_JAX_SCRIPT = r"""
import sys, pkgutil, importlib, os
sys.modules["jax"] = None
import speedseq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    speedseq_tpu_torch.__path__, "speedseq_tpu_torch.")
    if not m.name.endswith("__main__")]
assert {"speedseq_tpu_torch.align.realign", "speedseq_tpu_torch.var.somatic",
        "speedseq_tpu_torch.var.annotate", "speedseq_tpu_torch.formats.cram",
        "speedseq_tpu_torch.formats.bamutil", "speedseq_tpu_torch.ops.fm_search",
        "speedseq_tpu_torch.align.seeding"} <= set(names)
for n in names:
    importlib.import_module(n)
assert not any(k == "speedseq_tpu" or k.startswith("speedseq_tpu.")
               for k in sys.modules), "speedseq_tpu got imported"
from speedseq_tpu_torch.utils import synth
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.bam import read_bam
d = sys.argv[1]
g = synth.make_genome((6000, 4000, 3000), seed=1)
fa = os.path.join(d, "g.fa")
synth.write_fasta(fa, g)
rd = synth.simulate(g, 24, read_len=100, seed=2, kill_frac=0.0)
synth.write_fastq_pair(os.path.join(d, "1.fq"), os.path.join(d, "2.fq"), rd)
out = align_fastq(fa, os.path.join(d, "1.fq"), os.path.join(d, "2.fq"),
                  out_prefix=os.path.join(d, "o"),
                  config=AlignConfig(batch_size=16), device="cpu")
_, recs = read_bam(out["bam"])
assert len(recs) >= 48, len(recs)
print("OK", len(names), len(recs))
"""


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dp, _, fs in os.walk(PKG):
        out += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    return out


def test_port_imports_and_aligns_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    """AST scan: no absolute import of jax or speedseq_tpu anywhere."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    banned = ("jax", "speedseq_tpu")
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for m in mods:
            top = m.split(".")[0]
            assert top not in banned, f"{path}:{node.lineno} imports {m}"


def test_align_without_device_needs_cuda(tmp_path, monkeypatch):
    """No device given means cuda; without a card that raises instead of
    running on the CPU (the same holds for an explicit 'cuda')."""
    from speedseq_tpu_torch.align.pipeline import align_fastq
    from speedseq_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fq = tmp_path / "x.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        align_fastq(str(tmp_path / "missing.fa"), str(fq))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cli_align_flags_and_unported_subcommands(capsys):
    from speedseq_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["align", "-R", "@RG\\tID:a\\tSM:b", "ref.fa", "r1.fq", "r2.fq"])
    assert args.device == "cuda" and args.seed_mode == "hash"
    cfg = cli._align_config(args)
    assert cfg.rg_id == "a" and cfg.sample == "b"
    # every subcommand is ported, FM seeding included: nothing is refused
    for sub in ("realign", "var", "somatic", "sv"):
        assert cli.build_parser().parse_args(
            [sub, "-K", "k.cfg", "-B", "x.bam"] if sub == "sv" else
            [sub, "-K", "k.cfg", "ref.fa", "a.bam", "b.bam"]).device == "cuda"
    for sub in ("align", "realign"):
        fm = cli.build_parser().parse_args(
            [sub, "--seed-mode", "fm", "-R", "@RG\\tID:a", "ref.fa", "in"])
        assert cli._align_config(fm).seed_mode == "fm"
    assert not hasattr(cli, "_refuse_fm")
    assert "not ported" not in capsys.readouterr().err
