"""The port's multi-process runs (speedseq_tpu_torch.parallel.multihost).

In process, against the JAX package's speedseq_tpu.parallel.multihost:
the dup marker driven by a two-member exchange (and against one
StreamDupMarker fed the batches in stream order), the resume agreement,
the coordinate boundaries, the sv result packing, the FileExchange file
format (a port member and a JAX member exchange), make_exchange's choice,
and the wave tag of the merged parts.

Subprocesses, two ``--device cpu`` workers (one torch thread each), on a
random 20 kbp genome with germline and somatic SNVs and a deletion: align
merged over FileExchange, align resharded over gloo CollectiveExchange,
a resharded align that fails in its third batch and resumes from its
checkpoints, var, somatic and two-sample sv — each record-equal to the
port's single-process run of the same inputs.  (tests/test_multihost.py
reads the absent chr20 reference, so it cannot be mirrored as is.)"""

import gzip
import json
import os
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from speedseq_tpu.parallel import multihost as jmh
from speedseq_tpu.sv import engine as jsv_engine
from speedseq_tpu.sv.svtyper import GenotypeResult as JGenotypeResult
from speedseq_tpu_torch.align.markdup import StreamDupMarker
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
from speedseq_tpu_torch.formats.bam import read_bam
from speedseq_tpu_torch.parallel import multihost as tmh
from speedseq_tpu_torch.sv import engine as tsv_engine
from speedseq_tpu_torch.sv.svtyper import GenotypeResult
from speedseq_tpu_torch.utils import sim, sv_cases
from speedseq_tpu_torch.utils.somatic_cases import write_fasta
from speedseq_tpu_torch.var.engine import VarConfig, run_var
from speedseq_tpu_torch.var.somatic import SomaticConfig, somatic_filter

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIPLE = ("bam", "splitters.bam", "discordants.bam")
INSERT = "320,50,520,120"
WORKER_TIMEOUT_S = 180


# ------------------------------------------------------------- in process

class _PairExchange:
    """An in-process allgather of ``n`` members (one thread each)."""

    def __init__(self, n):
        self.n = n
        self.slots = {}
        self.barrier = threading.Barrier(n)

    def member(self, pid):
        ex = self

        class M:
            P, pid_ = ex.n, pid

            def allgather(self, wave, payload):
                ex.slots[(wave, pid)] = payload
                ex.barrier.wait()
                out = [ex.slots[(wave, p)] for p in range(ex.n)]
                ex.barrier.wait()
                return out

        m = M()
        m.pid = pid
        return m


def _sig_batches(n_batches, seed):
    """Dup-signature batches with repeats across batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(5, 30))
        cols = [rng.integers(0, 2, n), rng.integers(0, 40, n),
                rng.integers(0, 2, n), rng.random(n) < 0.9,
                rng.integers(0, 2, n), rng.integers(0, 40, n),
                rng.integers(0, 2, n), rng.random(n) < 0.8]
        out.append([np.asarray(c, np.int64) for c in cols])
    return out


def _run_markers(cls, batches, P=2):
    """Each member marks its round-robin share of ``batches`` (then pads
    to the common wave count); returns the dup flags in stream order."""
    ex = _PairExchange(P)
    waves = (len(batches) + P - 1) // P
    got = {}

    def run(pid):
        m = cls(ex.member(pid))
        for bi in range(pid, len(batches), P):
            got[bi] = np.asarray(m.mark_batch(*batches[bi]))
        m.finish(waves)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(P)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return [got[bi] for bi in range(len(batches))]


def test_wave_sync_dup_marker_matches_jax_and_one_stream():
    batches = _sig_batches(7, seed=3)
    port = _run_markers(tmh.WaveSyncDupMarker, batches)
    jax_ = _run_markers(jmh.WaveSyncDupMarker, batches)
    one = StreamDupMarker()
    for bi, b in enumerate(batches):
        want = np.asarray(one.mark_batch(*b))
        np.testing.assert_array_equal(port[bi], want)
        np.testing.assert_array_equal(jax_[bi], want)
    assert any(np.asarray(p).any() for p in port)


def test_agree_resume_takes_the_last_common_checkpoint():
    ex = _PairExchange(2)
    got = {}

    def run(pid, batches):
        m = tmh.WaveSyncDupMarker(ex.member(pid))
        got[pid] = (m.agree_resume(batches), m.wave)

    ts = [threading.Thread(target=run, args=a)
          for a in ((0, [2, 4, 6]), (1, [2, 4]))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert got == {0: (4, 4), 1: (4, 4)}


@pytest.mark.parametrize("P", [2, 3, 5])
def test_coordinate_boundaries_match_jax(P):
    refs = [("a", 12_345), ("b", 777), ("c", 50_000)]
    np.testing.assert_array_equal(tmh.coordinate_boundaries(refs, P),
                                  jmh.coordinate_boundaries(refs, P))


def test_pack_grs_matches_jax():
    fields = [dict(gt="0/1", gq=42, sq=17.5, gl=[-3.0, -0.5, -9.25], dp=30,
                   ro=12, ao=9, rs=5, as_=4, rp=7, ap=5, ab=0.43),
              dict(gt="./.", gq=0, sq=0.0, gl=[0.0, -1.0], dp=0, ro=0,
                   ao=0, rs=0, as_=0, rp=0, ap=0, ab=0.0)]
    tg = [GenotypeResult(**f) for f in fields] + [None]
    jg = [JGenotypeResult(**f) for f in fields] + [None]
    t, j = tsv_engine._pack_grs(tg), jsv_engine._pack_grs(jg)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_array_equal(np.nan_to_num(t), np.nan_to_num(j))
    back = tsv_engine._unpack_grs(t)
    assert back[0] == tg[0] and back[2] is None
    assert back[1].gl == [0.0, -1.0, 0.0]


def test_file_exchange_port_and_jax_members(tmp_path):
    """A port member and a JAX member of one FileExchange run: the same
    file format, both ways, for allgather and alltoall."""
    out = {}

    def run(pid, mod):
        ex = mod.FileExchange(str(tmp_path), 2, pid, timeout=30,
                              run_id="r1")
        a = ex.allgather(3, bytes([pid]) * (pid + 2))
        b = ex.alltoall(4, [f"{pid}>{d}".encode() for d in range(2)])
        out[pid] = (a, b)

    ts = [threading.Thread(target=run, args=a)
          for a in ((0, tmh), (1, jmh))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for pid in (0, 1):
        assert out[pid][0] == [b"\x00\x00", b"\x01\x01\x01"]
        assert out[pid][1] == [f"0>{pid}".encode(), f"1>{pid}".encode()]
    with pytest.raises(TimeoutError, match="process 1 missing"):
        tmh.FileExchange(str(tmp_path), 2, 0, timeout=0.05,
                         run_id="r2").allgather(0, b"x")


def test_worker_world_from_torchrun_env(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert tmh._world("env", "env") == (4, 3)
    assert tmh._world("2", "1") == (2, 1)


def test_make_exchange_without_a_group(tmp_path):
    ex = tmh.make_exchange(str(tmp_path), 2, 1, run_id="r")
    assert isinstance(ex, tmh.FileExchange) and (ex.P, ex.pid) == (2, 1)


def test_wave_tag_round_trip():
    """Records with their wave appended come back whole, in part order."""
    recs = [b"\x00" * 32 + bytes([i]) * (3 + i) for i in range(4)]
    blob = b"".join(struct.pack("<i", len(r)) + r for r in recs)
    sizes = np.array([len(r) + 4 for r in recs], np.int64)
    tagged = tmh._append_wave(np.frombuffer(blob, np.uint8), sizes, 7)
    at = 0
    for r in recs:
        (sz,) = struct.unpack_from("<i", tagged, at)
        assert sz == len(r) + 4
        body = bytes(tagged[at + 4: at + 4 + sz])
        assert body[:-4] == r and struct.unpack("<i", body[-4:]) == (7,)
        at += 4 + sz
    assert at == len(tagged)


@pytest.mark.parametrize("headerless", [False, True])
def test_spilled_sort_keeps_intake_order_of_ties(tmp_path, headerless):
    """ExternalBAMSorter over spilled chunks writes what it writes from
    memory: equal keys in intake order (the reference's chunk merge
    compared record bytes there), and whole records in a headerless part
    (the reference dropped their block_size)."""
    from speedseq_tpu_torch.formats.bgzf import BGZFReader
    from speedseq_tpu_torch.formats.extsort import ExternalBAMSorter
    from speedseq_tpu_torch.formats.sam import SAMHeader, SAMRecord

    header = SAMHeader.build(refs=[("c", 1000)])
    recs = [SAMRecord(qname=f"r{i:02d}", flag=0, tid=0, pos=(7 * i) % 5,
                      mapq=60, cigar=[(0, 4)], mtid=-1, mpos=-1, tlen=0,
                      seq="ACGT", qual="IIII")
            for i in range(40, 0, -1)]

    def body(n_max):
        path = str(tmp_path / f"s{n_max}.bam")
        srt = ExternalBAMSorter(path, header, max_records=n_max,
                                headerless=headerless)
        for k in range(0, len(recs), 4):
            srt.add_many(recs[k:k + 4])
        srt.close()
        if not headerless:
            return [r.qname for r in read_bam(path)[1]]
        with BGZFReader(path) as r:
            data = r.read(1 << 20)
        names, at = [], 0
        while at < len(data):
            (sz,) = struct.unpack_from("<i", data, at)
            names.append(data[at + 36: at + 36 + 3].decode())
            at += 4 + sz
        return names

    memory, spilled = body(1000), body(8)
    assert spilled == memory
    by_key = sorted(recs, key=lambda r: r.pos)      # stable: intake order
    assert memory == [r.qname for r in by_key]


# ----------------------------------------------------------- subprocesses

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 20 kbp contig; a normal (germline SNVs on one haplotype) and a
    tumor (the germline haplotype, and one with somatic SNVs and a 1.5 kbp
    deletion), aligned by the port in one process on the CPU.  The tumor
    keeps the default read group, as the align workers write it."""
    d = tmp_path_factory.mktemp("tmh")
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 20_000).astype(np.uint8)
    fa = str(d / "g.fa")
    write_fasta(fa, "chrM1", g)
    hap_b, _, _ = sim.mutate(g, rng, snv_rate=0.002, indel_rate=0.0)
    hap_a = g.copy()
    for p in range(1_500, 19_000, 2_500):
        hap_a[p] = (hap_a[p] + 1) % 4
    hap_a = sv_cases.apply_events(hap_a, [("DEL", 12_000, 1_500)], 0,
                                  len(hap_a))
    ins = (320.0, 50.0, 520, 120)
    out = {"d": d, "fa": fa}
    for tag, src, n in (("normal", g, 600), ("tumor", hap_a, 900)):
        reads = sim.simulate_pairs(src, n, read_len=100, seed=len(tag),
                                   diploid_genome=hap_b, name_prefix=tag)
        f1, f2 = str(d / f"{tag}_1.fq"), str(d / f"{tag}_2.fq")
        sim.to_fastq(f1, f2, *reads[:5])
        rg = dict(sample=tag, rg_id=tag) if tag == "normal" else {}
        out[tag] = align_fastq(
            fa, f1, f2, out_prefix=str(d / tag),
            config=AlignConfig(batch_size=128, insert_override=ins, **rg),
            device="cpu")
        out[tag + "_fq"] = (f1, f2)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _workers(args, gloo=False, crash_after=None):
    """Two worker processes (``args`` with the pid in place of "{pid}");
    returns [(returncode, stdout, stderr)], killing both on a timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("SSQ_COORDINATOR", None)
    if gloo:
        env["SSQ_COORDINATOR"] = f"localhost:{_free_port()}"
    if crash_after is None:
        head = [sys.executable, "-m", "speedseq_tpu_torch.parallel.multihost"]
    else:
        # the host epilogue fails in the batch after ``crash_after``
        head = [sys.executable, "-c", (
            "import sys\n"
            "import speedseq_tpu_torch.align.emit as emit\n"
            "from speedseq_tpu_torch.parallel import multihost\n"
            "real, n = emit.build_batch_records, [0]\n"
            "def step(*a, **k):\n"
            "    n[0] += 1\n"
            f"    if n[0] > {crash_after}:\n"
            "        raise RuntimeError('injected failure')\n"
            "    return real(*a, **k)\n"
            "emit.build_batch_records = step\n"
            "raise SystemExit(multihost.main(sys.argv[1:]))\n")]
    procs = [subprocess.Popen(
        head + [a.replace("{pid}", str(p)) for a in args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(2)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode,) + o for p, o in zip(procs, outs)]


def _ok(res):
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    return res[0][1].strip().splitlines()[-1]


def _align_args(world, prefix, *extra):
    f1, f2 = world["tumor_fq"]
    d = world["d"]
    return ["align", world["fa"], f1, f2, str(d / prefix), "2", "{pid}",
            str(d / f"ex_{prefix}"), "128", INSERT, f"run_{prefix}",
            *extra, "--device", "cpu"]


def _assert_triple_equal(want, got):
    for k in TRIPLE:
        hw, rw = read_bam(want[k])
        hg, rg = read_bam(got[k])
        assert hw.text == hg.text, k
        assert len(rw) == len(rg) > 0 or k != "bam", k
        for a, b in zip(rw, rg):
            assert a == b, (k, a.qname, a.flag)
        assert os.path.exists(got[k] + ".bai")


def test_two_process_align_merged(world):
    res = _workers(_align_args(world, "merged"))
    assert all("FileExchange on cpu" in out for _, out, _ in res)
    _assert_triple_equal(world["tumor"], json.loads(_ok(res)))


def test_two_process_align_resharded_over_gloo(world):
    res = _workers(_align_args(world, "resh", "reshard"), gloo=True)
    assert all("CollectiveExchange on cpu" in out for _, out, _ in res)
    _assert_triple_equal(world["tumor"], json.loads(_ok(res)))


def test_two_process_resharded_align_resumes(world):
    """Both workers (4 batches each, a checkpoint after every batch) fail
    in their third batch; the rerun with --resume agrees on batch 2 and
    finishes with the records of one process."""
    args = _align_args(world, "resume", "reshard", "--checkpoint-every", "1")
    failed = _workers(args, gloo=True, crash_after=2)
    assert all(rc != 0 for rc, _, _ in failed)
    assert all("injected failure" in err for _, _, err in failed)
    d = world["d"]
    for p in range(2):
        assert os.path.getsize(d / f"resume.part{p}.align.ckpt") > 0
    out = json.loads(_ok(_workers(args + ["--resume"], gloo=True)))
    _assert_triple_equal(world["tumor"], out)
    assert not os.path.exists(d / "resume.part0.align.ckpt")


def _vcf_records(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return ([l for l in lines if l.startswith("#")],
            [l for l in lines if not l.startswith("#")])


@pytest.mark.parametrize("somatic", [False, True], ids=["var", "somatic"])
def test_two_process_var(world, somatic):
    d, fa = world["d"], world["fa"]
    bams = ([world["normal"]["bam"], world["tumor"]["bam"]] if somatic
            else [world["tumor"]["bam"]])
    tag = "som" if somatic else "var"
    record_filter = None
    if somatic:
        scfg = SomaticConfig()
        cfg = VarConfig(min_qual=0.0, caller=scfg.caller,
                        apply_balance_filter=False, window_size=4000)
        record_filter = somatic_filter(scfg)
    else:
        cfg = VarConfig(window_size=4000)
    single = run_var(fa, bams, str(d / f"single.{tag}.vcf.gz"), config=cfg,
                     record_filter=record_filter, _somatic_header=somatic,
                     device="cpu")
    multi = str(d / f"multi.{tag}.vcf.gz")
    res = _workers(["var", fa, ",".join(bams), multi, "2", "{pid}",
                    str(d / f"ex_{tag}"), f"run_{tag}", "4000"]
                   + (["somatic"] if somatic else []) + ["--device", "cpu"])
    assert _ok(res) == multi
    hs, rs = _vcf_records(single)
    hm, rm = _vcf_records(multi)
    assert hm == hs and rm == rs and len(rs) > 0
    assert os.path.exists(multi + ".tbi")
    if somatic:
        assert any("ID=SSC" in l for l in hm)
        with open(str(d / "multi.som.ped")) as fh:
            ped = fh.read()
        assert "normal" in ped and "sample" in ped


def test_two_process_sv_two_samples(world):
    d = world["d"]
    samples = [tsv_engine.SVSample(n, *(world[n][k] for k in TRIPLE))
               for n in ("tumor", "normal")]
    single = tsv_engine.run_sv(samples, str(d / "single.sv.vcf.gz"),
                               tsv_engine.SVConfig(), device="cpu")
    multi = str(d / "multi.sv.vcf.gz")
    specs = [f"{s.name}:{s.full}:{s.splitters}:{s.discordants}"
             for s in samples]
    res = _workers(["sv", multi, "2", "{pid}", str(d / "ex_sv"), "run_sv",
                    *specs, "--device", "cpu"])
    assert _ok(res) == multi
    assert all("[sv-mh] p" in out for _, out, _ in res)
    hs, rs = _vcf_records(single)
    hm, rm = _vcf_records(multi)
    assert hm == hs and rm == rs
    assert any("SVTYPE=DEL" in r for r in rs)
