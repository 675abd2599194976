"""End to end: the port's align_fastq(device="cpu") against the JAX
package's align_fastq on a 3-contig ~60 kbp genome with a duplicated
segment, planted deletions and seed-killed mates.  The three BAMs must be
record-equal and their headers equal apart from @PG; the port's
kill-and-resume run must reproduce its uninterrupted run byte for byte.

The JAX run takes its Pallas kernels in interpret mode (test-side
monkeypatches: the kernels forced to interpret mode, and the pipeline told
the kernels are usable), with the traceback kernel's NM withheld so that
the JAX epilogue recounts it (tests/nm_recount.py: the kernel counts some
mismatches twice, the port once).  batch_size=60 is not a multiple of the 8 virtual
CPU devices, so the JAX run stays on its single-device path.  Read indices
≡ 0 mod 60 (row 0 of every batch) are kept out of the seed-killed subset:
the reference's mate rescue lets dead lanes write row 0, which the port
does not reproduce (tests/test_torch_core.py shows the port rescuing it).
"""

import os

import numpy as np
import pytest

import speedseq_tpu.align.pipeline as jpipe
import speedseq_tpu.ops.sw_pallas as spl
from speedseq_tpu.formats.bam import read_bam
from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq, align_stream
from speedseq_tpu_torch.formats import fastq as tfastq
from speedseq_tpu_torch.utils import synth

from nm_recount import Genome, assert_record_equal, no_kernel_nm

BATCH = 60
OUTS = ("bam", "splitters.bam", "discordants.bam")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("talign")
    g = synth.make_genome(seed=11, n_del=12)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 360, read_len=100, seed=13, kill_frac=0.05,
                        protect_mod=BATCH)
    synth.write_fastq_pair(str(d / "r1.fq"), str(d / "r2.fq"), rd)
    return d, fa, rd


@pytest.fixture(scope="module")
def both_runs(inputs):
    d, fa, _ = inputs
    f1, f2 = str(d / "r1.fq"), str(d / "r2.fq")
    port = align_fastq(fa, f1, f2, out_prefix=str(d / "port"),
                       config=AlignConfig(batch_size=BATCH), device="cpu")
    mp = pytest.MonkeyPatch()
    oc, os_ = spl.sw_pallas_cigar, spl.sw_pallas
    mp.setattr(spl, "sw_pallas_cigar", no_kernel_nm(oc))
    mp.setattr(spl, "sw_pallas",
               lambda *a, interpret=False, **k: os_(*a, interpret=True, **k))
    mp.setattr(jpipe, "_pallas_ok", lambda: True)
    try:
        ref = jpipe.align_fastq(fa, f1, f2, out_prefix=str(d / "jax"),
                                config=jpipe.AlignConfig(batch_size=BATCH))
    finally:
        mp.undo()
    return ref, port


def _no_pg(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.mark.parametrize("out", OUTS)
def test_bam_triple_record_equal(both_runs, inputs, out):
    """Every field equal; NM as tests/nm_recount.py holds it (the JAX run
    recounts its primaries' NM on the host, the port's XA NM is the
    entry's edit distance)."""
    ref, port = both_runs
    genome = Genome(inputs[1])
    hj, rj = read_bam(ref[out])
    hp, rp = read_bam(port[out])
    assert _no_pg(hj.text) == _no_pg(hp.text)
    assert "@PG\tID:speedseq_tpu_torch" in hp.text
    assert len(rj) == len(rp)
    for a, b in zip(rj, rp):
        assert_record_equal(a, b, genome)
    assert os.path.exists(port[out] + ".bai")


def test_fixture_exercises_the_paths(both_runs, inputs):
    """Seed-killed mates are rescued, the deletion yields split reads, and
    the duplicated segment yields XA alternatives."""
    _, port = both_runs
    _, _, rd = inputs
    _, recs = read_bam(port["bam"])
    killed = {rd.names[i] for i in np.nonzero(rd.killed)[0]}
    r2 = [r for r in recs if r.qname in killed and r.flag & 0x80
          and not r.flag & 0x800]
    assert r2 and sum(not r.flag & 0x4 for r in r2) >= len(r2) // 2
    _, spl_recs = read_bam(port["splitters.bam"])
    assert spl_recs
    assert any(r.get_tag("XA") for r in recs)


def test_port_kill_and_resume_matches_full_run(inputs, tmp_path):
    """Crash after two batches with a checkpoint journal, resume from it
    with the full input: outputs byte-identical to an uninterrupted run."""
    d, fa, _ = inputs
    f1, f2 = str(d / "r1.fq"), str(d / "r2.fq")
    cfg = AlignConfig(batch_size=BATCH, checkpoint=True, checkpoint_every=1,
                      sort_max_records=200)
    full = align_fastq(fa, f1, f2, out_prefix=str(tmp_path / "full"),
                       config=cfg, device="cpu")

    class Stop(Exception):
        pass

    def limited(it, n):
        for i, x in enumerate(it):
            if i >= n:
                raise Stop()
            yield x

    pref = str(tmp_path / "resume")
    batches = tfastq.iter_batches(f1, batch_size=BATCH, max_len=151,
                                  paired_with=f2)
    with pytest.raises(Stop):
        align_stream(fa, limited(batches, 2), pref, cfg, device="cpu")
    assert os.path.exists(pref + ".align.ckpt")
    cfg2 = AlignConfig(batch_size=BATCH, checkpoint=True, checkpoint_every=1,
                       sort_max_records=200, resume=True)
    outs = align_fastq(fa, f1, f2, out_prefix=pref, config=cfg2,
                       device="cpu")
    assert not os.path.exists(pref + ".align.ckpt")
    for k in OUTS:
        with open(full[k], "rb") as a, open(outs[k], "rb") as b:
            assert a.read() == b.read(), k
