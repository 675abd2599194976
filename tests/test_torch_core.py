"""The port's device step (speedseq_tpu_torch.align.core) against the JAX
package's, on one paired batch: phase-1 candidates, pair selection, slot
choice, extension, extra-XA extension, mate rescue and the packed fused
outputs (through unpack_*) bit-equal; the device insert-distro estimate
within rtol 1e-5 (its float32 sums run in another order).

The JAX kernels run in Pallas interpret mode (test-side monkeypatches, as
off the TPU the JAX package would otherwise take its unbanded XLA path)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import speedseq_tpu.ops.sw_pallas as spl
from speedseq_tpu.align import core as jcore
from speedseq_tpu.align.pipeline import _load_fm as jax_load_fm
from speedseq_tpu.align.sw import SWParams as JParams
from speedseq_tpu_torch.align import core as tcore
from speedseq_tpu_torch.align.sw import SWParams as TParams
from speedseq_tpu_torch.index.kmer import index_from_numpy
from speedseq_tpu_torch.utils import synth

B, L = 60, 151
DISTRO = [320.0, 50.0, 120.0, 520.0]


@pytest.fixture(scope="module")
def interpret_pallas():
    mp = pytest.MonkeyPatch()
    oc, os_ = spl.sw_pallas_cigar, spl.sw_pallas
    mp.setattr(spl, "sw_pallas_cigar",
               lambda *a, interpret=False, **k: oc(*a, interpret=True, **k))
    mp.setattr(spl, "sw_pallas",
               lambda *a, interpret=False, **k: os_(*a, interpret=True, **k))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(tmp_path_factory, interpret_pallas):
    d = tmp_path_factory.mktemp("tcore")
    g = synth.make_genome(seed=7)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    idx, jf, jk = jax_load_fm(fa, "hash")
    tf, tk = index_from_numpy(
        idx.pac, idx.names, idx.lengths, idx.offsets, device="cpu",
        kmer_arrays=(np.asarray(jk.bucket_start), np.asarray(jk.positions),
                     np.asarray(jk.fp), int(jk.bits)))
    rd = synth.simulate(g, B, read_len=100, seed=9, kill_frac=0.1,
                        protect_mod=B)
    seqs, lens = [], []
    for s in (rd.seq1, rd.seq2):
        x = np.full((B, L), 4, np.uint8)
        x[:, :100] = s
        seqs.append(x)
        lens.append(np.full(B, 100, np.int32))
    lens[0][5] = 70
    seqs[0][5, 70:] = 4
    j_in = [jnp.asarray(a) for a in (seqs[0], lens[0], seqs[1], lens[1])]
    t_in = [torch.from_numpy(a) for a in (seqs[0], lens[0], seqs[1], lens[1])]
    return dict(jf=jf, jk=jk, tf=tf, tk=tk, j=j_in, t=t_in, rd=rd,
                offsets=list(idx.offsets),
                jd=jnp.asarray(DISTRO, jnp.float32),
                td=torch.tensor(DISTRO, dtype=torch.float32))


def _eq(a, b, name=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


def _eq_cand(jc, tc, skip=()):
    """Candidates/XACompact equality; cigars compared below n_ops."""
    n = np.asarray(jc.n_ops)
    below = np.arange(np.asarray(jc.cigar_ops).shape[-1]) < n[..., None]
    for name in jc._fields:
        if name in skip:
            continue
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        if name in ("cigar_ops", "cigar_len"):
            a, b = np.where(below, a, 0), np.where(below, b, 0)
        _eq(a, b, name)


@pytest.fixture(scope="module")
def phase1(setup):
    s = setup
    jsc = [jcore.weight_candidates(s["jf"], s["j"][2 * e], s["j"][2 * e + 1],
                                   kidx=s["jk"]) for e in (0, 1)]
    tsc = tcore.weight_candidates(
        s["tf"], [(s["t"][0], s["t"][1]), (s["t"][2], s["t"][3])],
        kidx=s["tk"])
    return jsc, tsc


def test_weight_candidates_bit_equal(phase1):
    jsc, tsc = phase1
    for j, t in zip(jsc, tsc):
        for name in j._fields:
            _eq(getattr(j, name), getattr(t, name), name)
    assert (np.asarray(jsc[1].score).max(1) <= 0).any()  # seed-killed ends


def test_pair_select_and_choose_bit_equal(setup, phase1):
    s = setup
    jsc, tsc = phase1
    jk1, jk2 = jcore._device_pair_select(jsc[0], jsc[1], s["jd"])
    tk1, tk2 = tcore._device_pair_select(tsc[0], tsc[1], s["td"])
    _eq(jk1, tk1, "k1")
    _eq(jk2, tk2, "k2")
    for e, (jk, tk) in enumerate(((jk1, tk1), (jk2, tk2))):
        jch = jcore._device_choose(jsc[e], s["j"][2 * e + 1], jk)
        tch = tcore._device_choose(tsc[e], s["t"][2 * e + 1], tk)
        for name, a, b in zip(
                ("a_rpos", "a_qpos", "a_strand", "sub", "sub_n", "xa_mask"),
                jch, tch):
            _eq(a, b, name)


def test_extend_xa_and_rescue_bit_equal(setup, phase1):
    s = setup
    jsc, tsc = phase1
    jk1, jk2 = jcore._device_pair_select(jsc[0], jsc[1], s["jd"])
    tk1, tk2 = tcore._device_pair_select(tsc[0], tsc[1], s["td"])
    jp, tp = JParams(), TParams()
    for e, jkk, tkk, jo, to in ((0, jk1, tk1, jk2, tk2),
                                (1, jk2, tk2, jk1, tk1)):
        jr, jl = s["j"][2 * e], s["j"][2 * e + 1]
        tr, tl = s["t"][2 * e], s["t"][2 * e + 1]
        arp, aqp, ast, _, _, xam = jcore._device_choose(jsc[e], jl, jkk)
        tarp, taqp, tast, _, _, txam = tcore._device_choose(tsc[e], tl, tkk)
        jc = jcore.extend_candidates(s["jf"], jr, jl, arp, aqp, ast,
                                     use_pallas=True)
        tc = tcore.extend_candidates(s["tf"], tr, tl, tarp, taqp, tast)
        _eq_cand(jc, tc)
        assert (np.asarray(jc.nm)[np.asarray(jc.score) > 0] >= 0).all()
        jx = jcore._extend_xa(s["jf"], jsc[e], xam, jr, jl, jp, True)
        tx = tcore._extend_xa(s["tf"], tsc[e], txam, tr, tl, tp)
        _eq_cand(jx, tx)
        jm = jcore._mate_rescue(s["jf"], jc, jsc[e], jsc[1 - e], jo, jr, jl,
                                s["jd"], jp, True)
        tm = tcore._mate_rescue(s["tf"], tc, tsc[e], tsc[1 - e], to, tr, tl,
                                s["td"], tp)
        _eq_cand(jm, tm)
        if e == 1:  # most seed-killed ends got rescued into slot 0
            dead = np.asarray(jsc[1].score).max(1) <= 0
            rescued = np.asarray(jm.score)[dead, 0] >= 30
            assert rescued.sum() >= max(1, dead.sum() // 2)


def test_fused_leaves_bit_equal(setup):
    s = setup
    jo = jcore.fused_align_leaves(s["jf"], *s["j"], distro=s["jd"],
                                  use_pallas=True, kidx=s["jk"])
    to = tcore.fused_align_leaves(s["tf"], *s["t"], distro=s["td"],
                                  kidx=s["tk"])
    ju = jcore.unpack_leaves(np.asarray(jo[0]), np.asarray(jo[1]))
    tu = tcore.unpack_leaves(to[0].numpy(), to[1].numpy())
    for name, a, b in zip(("meta", "xa_meta", "overflow", "cig16", "xa_cig"),
                          ju, tu):
        _eq(a, b, name)
    for je, te in zip(jcore.unpack_fused(ju[0], ju[3]),
                      tcore.unpack_fused(tu[0], tu[3])):
        for name in je._fields:
            _eq(getattr(je, name), getattr(te, name), name)
    for je, te in zip(jcore.unpack_xa(ju[1], ju[4]),
                      tcore.unpack_xa(tu[1], tu[4])):
        for name in je._fields:
            _eq(getattr(je, name), getattr(te, name), name)
    _eq(jo[3], to[3], "stats")
    jdist = jcore.device_estimate_distro(jo[3], s["jd"], qlen=L)
    tdist = tcore.device_estimate_distro(to[3], s["td"], qlen=L)
    np.testing.assert_allclose(np.asarray(jdist), tdist.numpy(), rtol=1e-5)


def test_port_rescues_read_in_row_zero(setup):
    """The port scatters only live rescue lanes, so a seed-killed read in
    row 0 of a batch is rescued like any other (the JAX reference's dead
    lanes also write row 0, which the parity fixtures avoid)."""
    s = setup
    r1, l1, r2, l2 = (t.clone() for t in s["t"])
    r2[0, :100:9] = (r2[0, :100:9] + 1) % 4       # kill row 0's seeds
    out = tcore.fused_align_step(s["tf"], r1, l1, r2, l2, distro=s["td"],
                                 kidx=s["tk"])
    sc2 = out[1][3]
    assert sc2.score[0].max() <= 0                # no seeds left
    cand = out[1][0]
    assert int(cand.score[0, 0]) >= 30
    rd = s["rd"]
    tid, pos = int(rd.tid2[0]), int(rd.pos2[0])
    assert abs(int(cand.pos[0, 0]) - (s["offsets"][tid] + pos)) <= 12
