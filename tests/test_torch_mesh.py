"""The port's sharded runs of one process (speedseq_tpu_torch.parallel.mesh)
on CPU meshes, against one shard and against the JAX package's sharded
programs on the conftest's 8 virtual CPU devices:

(a) ``distributed_fused_step`` on ``[cpu] * 8`` is bit-equal to one shard,
    and to the JAX ``fused_align_packed`` (Pallas kernels in interpret
    mode) on the inputs of ``__graft_entry__._tiny_world``; XA lanes are
    compared as sets (their packing is per shard, as in JAX);
(b) ``coordinate_reshard`` equals the JAX reshard on ``make_mesh(8)`` with
    the inputs of ``tests/test_backend.py``, and with a small ``cap`` keeps
    the same rows and counts in ``dropped`` what the JAX reshard loses;
(c) sharded ``genotype_sites`` and SVTyper equal the port's unsharded runs
    bit for bit, and the JAX sharded programs within the tolerances of
    ``tests/test_torch_var.py`` and ``tests/test_torch_sv.py``;
(d) ``align_stream`` over 4 CPU shards writes the BAM triple of 1 shard;
and ``SSQ_TORCH_TRACE`` writes a Chrome trace of a CLI align run."""

import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import speedseq_tpu.ops.sw_pallas as spl
from speedseq_tpu.align import core as jcore
from speedseq_tpu.index.bwt import build_index as jbuild_index
from speedseq_tpu.index.fm import FMIndex as JFMIndex
from speedseq_tpu.index.kmer import build_kmer_index
from speedseq_tpu.parallel import mesh as jmesh
from speedseq_tpu.sv import svtyper as jsvtyper
from speedseq_tpu.sv.evidence import InsertStats as JInsertStats
from speedseq_tpu.sv import cluster as jcluster
from speedseq_tpu.utils.sim import simulate_pairs
from speedseq_tpu.var import device as jvdevice
from speedseq_tpu_torch.align import pipeline as tpipe
from speedseq_tpu_torch.formats import fastq as tfastq
from speedseq_tpu_torch.formats.bam import read_bam
from speedseq_tpu_torch.index.kmer import index_from_numpy
from speedseq_tpu_torch.parallel import mesh as tmesh
from speedseq_tpu_torch.sv import cluster as tcluster
from speedseq_tpu_torch.sv import device as tsdevice
from speedseq_tpu_torch.sv.evidence import InsertStats
from speedseq_tpu_torch.sv.svtyper import SVGenotyper
from speedseq_tpu_torch.utils import sv_cases, synth
from speedseq_tpu_torch.utils.var_cases import random_sites
from speedseq_tpu_torch.var import device as tvdevice

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


# ------------------------------------------------- (a) the sharded align step

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``__graft_entry__._tiny_world(genome_len=8_000, n_reads=64,
    read_len=80)``'s genome, index and reads, with the port's index built
    from the same arrays."""
    from speedseq_tpu.formats.fasta import decode_bases

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 8_000).astype(np.uint8)
    fa = str(tmp_path_factory.mktemp("tiny") / "g.fa")
    seq = decode_bases(genome).decode()
    with open(fa, "w") as fh:
        fh.write(">g\n" + "".join(seq[i:i + 60] + "\n"
                                  for i in range(0, len(seq), 60)))
    idx = jbuild_index(fa, write_files=False)
    jfm = JFMIndex.from_bwa(idx)
    jk = build_kmer_index(idx.pac)
    tfm, tk = index_from_numpy(
        idx.pac, idx.names, idx.lengths, idx.offsets, device="cpu",
        kmer_arrays=(np.asarray(jk.bucket_start), np.asarray(jk.positions),
                     np.asarray(jk.fp), int(jk.bits)))
    _, s1, _, _, _, _ = simulate_pairs(genome, 64, read_len=80, seed=1)
    reads = s1.astype(np.int32)
    lengths = np.full(64, 80, np.int32)
    return dict(jfm=jfm, jk=jk, tfm=tfm, tk=tk,
                r1=reads[:32], r2=reads[32:], l1=lengths[:32],
                l2=lengths[32:])


def _xa_set(xa_meta):
    xm = np.asarray(xa_meta)
    return {(e,) + tuple(int(x) for x in xm[e, :, j])
            for e in range(xm.shape[0]) for j in np.nonzero(xm[e, 0] >= 0)[0]}


def _port_step(tiny, devices):
    t = tiny
    mesh = tmesh.make_mesh(devices=devices)
    out = tmesh.distributed_fused_step(
        mesh, t["tfm"], t["r1"].astype(np.uint8), t["l1"],
        t["r2"].astype(np.uint8), t["l2"], kidx=t["tk"], n_chains=2)
    return [np.asarray(o) if not isinstance(o, torch.Tensor) else o.numpy()
            for o in out]


@pytest.fixture(scope="module")
def port_steps(tiny):
    return {n: _port_step(tiny, ["cpu"] * n) for n in (1, 8)}


def test_mesh_step_bit_equal_to_one_shard(port_steps):
    one, eight = port_steps[1], port_steps[8]
    for k, name in enumerate(("meta", "cig16", "cigar", "overflow",
                              "stats")):
        np.testing.assert_array_equal(one[k], eight[k], err_msg=name)
    assert _xa_set(one[5]) == _xa_set(eight[5])
    assert int(one[7]) == int(eight[7]) > 0          # n_aligned


def test_mesh_step_matches_jax(tiny, port_steps):
    t = tiny
    mp = pytest.MonkeyPatch()
    oc, os_ = spl.sw_pallas_cigar, spl.sw_pallas
    mp.setattr(spl, "sw_pallas_cigar",
               lambda *a, interpret=False, **k: oc(*a, interpret=True, **k))
    mp.setattr(spl, "sw_pallas",
               lambda *a, interpret=False, **k: os_(*a, interpret=True, **k))
    try:
        want = [np.asarray(o) for o in jcore.fused_align_packed(
            t["jfm"], *(jnp.asarray(a) for a in (t["r1"], t["l1"], t["r2"],
                                                 t["l2"])),
            distro=jnp.asarray([300.0, 100.0, 50.0, 700.0], jnp.float32),
            n_chains=2, use_pallas=True, paired=True, kidx=t["jk"])]
    finally:
        mp.undo()
    got = port_steps[8]
    for k, name in enumerate(("meta", "cig16", "cigar", "overflow",
                              "stats")):
        np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    # the JAX step's XA lanes, cigar heads and all
    assert _xa_set(got[5]) == _xa_set(want[5])
    want_aligned = int((((want[0][:, 3, :, 0]) & 0xFFFF) >= 30).sum())
    assert int(got[7]) == want_aligned


# ------------------------------------------------ (b) coordinate re-shard

def _reshard_inputs():
    """tests/test_backend.py:test_coordinate_reshard_all_to_all's."""
    n_dev, n_local, W = 8, 64, 3
    rng = np.random.default_rng(11)
    total_span = 1 << 20
    bounds = np.asarray(
        [total_span * k // n_dev for k in range(1, n_dev)], np.int64)
    keys = np.full((n_dev, n_local), jmesh.KEY_SENTINEL, np.int64)
    rows = np.zeros((n_dev, n_local, W), np.int64)
    n_live = rng.integers(10, n_local, n_dev)
    for p in range(n_dev):
        k = rng.integers(0, total_span, n_live[p])
        keys[p, : n_live[p]] = k
        rows[p, : n_live[p], 0] = k
        rows[p, : n_live[p], 1] = p
        rows[p, : n_live[p], 2] = np.arange(n_live[p])
    return keys, rows, bounds, n_live


@pytest.mark.parametrize("cap", [64, 4])
def test_coordinate_reshard_matches_jax(cap):
    keys, rows, bounds, n_live = _reshard_inputs()
    want = [np.asarray(x) for x in jmesh.coordinate_reshard(
        jmesh.make_mesh(8), keys, rows, bounds, cap=cap)]
    rk, rr, rc, dropped = (x.numpy() for x in tmesh.coordinate_reshard(
        tmesh.make_mesh(devices=CPU8), keys, rows, bounds, cap=cap))
    np.testing.assert_array_equal(rk, want[0])
    np.testing.assert_array_equal(rr, want[1])
    np.testing.assert_array_equal(rc, want[2])
    # dropped[src, dst]: every live row either arrived or is counted
    tgt = [np.searchsorted(bounds, keys[p, :n_live[p]], side="right")
           for p in range(8)]
    full = np.array([[int((tgt[p] == d).sum()) for d in range(8)]
                     for p in range(8)])
    np.testing.assert_array_equal(dropped, full - rc.T)
    assert (dropped.sum() > 0) == (cap < 64)


# -------------------------------------------- (c) sharded var and SVTyper

INT_FIELDS = ("gt_idx", "dp", "ro", "ao", "qr", "qa", "rpl", "rpr", "saf",
              "sar")


@pytest.mark.parametrize("n_samples,pooled,seed,S,R", [
    (3, False, 5, 150, 130), (2, True, 11, 100, 120)],
    ids=["3-samples", "2-samples-pooled"])
def test_sharded_genotype_sites(n_samples, pooled, seed, S, R):
    args = random_sites(seed, S, R, n_samples, 2 if pooled else 3)
    one = tvdevice.genotype_sites(*args, 0.001, n_samples, device="cpu",
                                  pooled=pooled)
    got = tvdevice.genotype_sites(*args, 0.001, n_samples, pooled=pooled,
                                  mesh=tmesh.make_mesh(devices=["cpu"] * 4))
    for f in one._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f),
                                      err_msg=f)
    if pooled:
        for a, b in zip(got.joint, one.joint):
            np.testing.assert_array_equal(a, b)
    want = jvdevice.genotype_sites(*args, 0.001, n_samples,
                                   mesh=jmesh.make_mesh(8), pooled=pooled)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert np.abs(got.gq.astype(int) - want.gq).max() <= 1
    np.testing.assert_allclose(got.gl, want.gl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.qual, want.qual, atol=1e-3, rtol=0)


COUNTS = ("gt", "dp", "ro", "ao", "rs", "as_", "rp", "ap", "ab")


@pytest.mark.parametrize("fixture", ["unmapped_tail_bam", "depth_tier_bam"])
def test_sharded_svtyper(fixture, tmp_path):
    bam = str(tmp_path / "t.bam")
    fields = getattr(sv_cases, fixture)(bam)
    tcalls = [tcluster.SVCall(**f) for f in fields]
    jcalls = [jcluster.SVCall(**f) for f in fields]
    g = SVGenotyper(bam, InsertStats.synthetic(300, 50), device="cpu")
    one = g.genotype_all(tcalls)
    got = g.genotype_all(tcalls, mesh=tmesh.make_mesh(devices=["cpu"] * 3))
    assert got == one
    jg = jsvtyper.SVGenotyper(bam, None, JInsertStats.synthetic(300, 50))
    want = jg.genotype_all(jcalls, mesh=jmesh.make_mesh(8))
    jg.close()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in COUNTS:
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        assert abs(a.gq - b.gq) <= 1
        assert abs(a.sq - b.sq) <= 0.05
        assert np.abs(np.subtract(a.gl, b.gl)).max() <= 1


def test_sharded_svtyper_program_random_ranges():
    """The program on random record ranges (C = 13 calls, not a multiple
    of the shards): 4 shards bit-equal to 1."""
    rng = np.random.default_rng(9)
    n = 500
    pos = np.sort(rng.integers(0, 50_000, n)).astype(np.int32)
    rlen = rng.integers(80, 120, n)
    rec = [torch.from_numpy(np.asarray(a)) for a in (
        pos, (pos + rlen).astype(np.int32), np.zeros(n, np.int32),
        np.zeros(n, np.int32), (pos + rng.integers(100, 500, n)).astype(
            np.int32), (pos + rng.integers(200, 700, n)).astype(np.int32),
        rng.random(n) < 0.95, rng.random(n) < 0.2, rng.random(n) < 0.2,
        rng.random(n) < 0.15, rng.random(n) < 0.5, rng.random(n) < 0.5,
        rng.random(n) < 0.7, rng.random(n) < 0.9)]
    C = 13
    p1 = rng.integers(1000, 40_000, C).astype(np.int32)
    p2 = (p1 + rng.integers(500, 5000, C)).astype(np.int32)
    calls = (rng.integers(0, 4, C).astype(np.int32), np.zeros(C, np.int32),
             p1, np.zeros(C, np.int32), p2,
             rng.integers(0, 2, C).astype(np.int32),
             rng.integers(0, 2, C).astype(np.int32))
    # each breakpoint's window: the records starting within 700 bp of it
    bp = np.stack([p1, p2], 1)
    a = np.searchsorted(pos, bp - 700)
    b = np.searchsorted(pos, bp + 400)
    R = int((b - a).max())
    scalars = (6, 400, 200, 400)
    one = tsdevice.svtyper_program(a, b, R, rec, calls, scalars,
                                   device="cpu")
    four = tsdevice.svtyper_program(
        a, b, R, rec, calls, scalars,
        mesh=tmesh.make_mesh(devices=["cpu"] * 4))
    for x, y in zip(one, four):
        assert torch.equal(x, y)
    assert int(one[0].sum() + one[1].sum()) > 0


# ------------------------------------------------- (d) align_stream shards

@pytest.fixture(scope="module")
def align_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tmesh")
    g = synth.make_genome(seed=21, n_del=6)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 256, read_len=100, seed=23, kill_frac=0.05,
                        protect_mod=64)
    synth.write_fastq_pair(str(d / "r1.fq"), str(d / "r2.fq"), rd)
    return d, fa


def _stream(d, fa, prefix, device):
    cfg = tpipe.AlignConfig(batch_size=64)
    batches = tfastq.iter_batches(str(d / "r1.fq"), batch_size=64,
                                  max_len=151, paired_with=str(d / "r2.fq"))
    return tpipe.align_stream(fa, batches, str(d / prefix), cfg,
                              device=device)


def test_align_stream_over_four_shards(align_inputs, monkeypatch):
    d, fa = align_inputs
    calls = []
    real = tmesh.distributed_fused_step
    monkeypatch.setattr(tmesh, "distributed_fused_step",
                        lambda mesh, *a, **k: calls.append(mesh.size)
                        or real(mesh, *a, **k))
    one = _stream(d, fa, "one", "cpu")
    assert not calls
    four = _stream(d, fa, "four", tmesh.make_mesh(devices=["cpu"] * 4))
    assert calls == [4] * 4
    for k in ("bam", "splitters.bam", "discordants.bam"):
        with gzip.open(one[k], "rb") as a, gzip.open(four[k], "rb") as b:
            assert a.read() == b.read(), k
    assert len(read_bam(one["bam"])[1]) >= 512
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        _stream(d, fa, "three", tmesh.make_mesh(devices=["cpu"] * 3))


def test_trace_hook_writes_a_chrome_trace(align_inputs, tmp_path,
                                          monkeypatch):
    from speedseq_tpu_torch import cli

    d, fa = align_inputs
    monkeypatch.setenv("SSQ_TORCH_TRACE", str(tmp_path / "trace"))
    prefix = str(d / "traced")
    assert cli.main(["align", "--device", "cpu", "--batch-size", "64", "-R",
                     "@RG\\tID:1\\tSM:s", "-o", prefix, fa,
                     str(d / "r1.fq"), str(d / "r2.fq")]) == 0
    assert os.path.exists(prefix + ".bam")
    files = glob.glob(str(tmp_path / "trace" / "align-*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert {"ssq.align.dispatch", "ssq.align.stage.extend"} <= names
