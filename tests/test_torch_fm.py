"""FM (SMEM) seeding of the port against the JAX package, on the CPU: the
FMD arrays of ``FMIndex.from_bwa_fm``, ``occ_all`` over every rank
(across ``primary``), both extensions for every base, ``sa_lookup`` dense
and by the LF walk, ``find_seeds``, ``chain_seeds`` (planted weight
ties), ``weight_candidates`` in the FM branch, and ``align_fastq(
seed_mode="fm")`` record-equal to the JAX run; then the CLI's ``align``
and ``realign --seed-mode fm``; numpy models of both kernels' steps (the
``fm_smem`` extension, the ``fm_sa_walk`` LF step on the walk records)
against the twins.  Integers are compared bit-equal.

The JAX align run takes its Pallas kernels in interpret mode (test-side
monkeypatches, as tests/test_torch_align.py does); batch_size=60 keeps it
off the conftest's 8-device mesh path.  The insert-size estimate on the
device is the hash path's code and is held there
(tests/test_torch_align.py, tests/test_torch_core.py).  The genomes are random
(``utils/synth.py``), written under ``tmp_path``."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import speedseq_tpu.align.pipeline as jpipe
import speedseq_tpu.ops.sw_pallas as spl
from speedseq_tpu.align import chain as jchain
from speedseq_tpu.align import core as jcore
from speedseq_tpu.align import seeding as jseed
from speedseq_tpu.formats.bam import read_bam
from speedseq_tpu.index import bwt as jbwt
from speedseq_tpu.index import fm as jfm
from speedseq_tpu_torch import cli
from speedseq_tpu_torch.align import chain as tchain
from speedseq_tpu_torch.align import core as tcore
from speedseq_tpu_torch.align import pipeline as tpipe
from speedseq_tpu_torch.align import seeding as tseed
from speedseq_tpu_torch.index import fm as tfm
from speedseq_tpu_torch.index.bwt import build_index, load_index
from speedseq_tpu_torch.index.suffix import suffix_array
from speedseq_tpu_torch.ops import fm_search
from speedseq_tpu_torch.utils import fm_cases, synth

from nm_recount import Genome, assert_record_equal, no_kernel_nm

torch.set_num_threads(1)

BATCH = 60
# -I pinned to the simulator's insert (mean 320, sd 50): every batch then
# takes the same device-step inputs, so the JAX step compiles once, not
# twice (with and without an estimated distro, ~100 s each here)
INSERT = (320.0, 50.0, 520, 120)
OUTS = ("bam", "splitters.bam", "discordants.bam")
FM_FIELDS = ("count", "occ_ckpt", "bwt", "sa_mark", "sa_ckpt", "sa_vals",
             "sa_dense")


_fmd_text = fm_cases.fmd_text


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _eq(j, t):
    return np.array_equal(_np(j), t.numpy())


@pytest.fixture(scope="module", autouse=True)
def _home(tmp_path_factory):
    """Both packages' SA disk caches go to a temporary HOME."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """One random 13 kbp genome: the port's index files, read back by the
    JAX package, and both packages' FMD indexes (dense and walk)."""
    d = tmp_path_factory.mktemp("tfm")
    g = synth.make_genome((6000, 4000, 3000), seed=5)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    build_index(fa)
    jidx = jbwt.load_index(fa)
    jsa = jfm._reconstruct_sa(jidx)
    tidx = load_index(fa)
    return {
        "genome": g, "jidx": jidx, "tidx": tidx, "jsa": jsa,
        "J": jfm.FMIndex.from_bwa(jidx, sa_full=jsa),
        "T": tfm.FMIndex.from_bwa_fm(tidx),
        "Jw": jfm.FMIndex.from_bwa(jidx, sa_full=jsa, dense_sa_max=0),
        "Tw": tfm.FMIndex.from_bwa_fm(tidx, dense_sa_max=0),
    }


@pytest.fixture(scope="module")
def batch(index):
    """Reads (B, 112) of 100 bp from the genome, every 7th cut to 60 bp,
    with an N, a seed-killed tenth and a random read."""
    rd = synth.simulate(index["genome"], 64, read_len=100, seed=7,
                        kill_frac=0.1)
    reads = np.full((64, 112), 4, np.uint8)
    reads[:, :100] = rd.seq1
    lens = np.full(64, 100, np.int32)
    lens[::7] = 60
    reads[::7, 60:] = 4
    reads[5, 30] = 4
    reads[9, :100] = np.random.default_rng(3).integers(0, 4, 100)
    return reads, lens


def test_sa_reconstruction(index):
    """The port's rank-sample walk, the JAX package's serial LF walk and a
    suffix sort of the FMD text give the same suffix array."""
    tsa = tfm._reconstruct_sa(index["tidx"])
    assert np.array_equal(tsa, index["jsa"])
    assert np.array_equal(tsa, suffix_array(_fmd_text(index["tidx"].pac)))


@pytest.mark.parametrize("field", FM_FIELDS + ("scalars",))
def test_fm_arrays_equal(index, field):
    J, T = index["J"], index["T"]
    if field == "scalars":
        assert (T.primary, T.seq_len, T.l_pac) == (
            int(J.primary), int(J.seq_len), int(J.l_pac))
        assert index["Tw"].sa_dense is None and index["Jw"].sa_dense is None
    else:
        assert getattr(T, field).dtype == torch.int32
        assert _eq(getattr(J, field), getattr(T, field))


def test_hash_index_carries_no_fm_arrays(index):
    T = tfm.FMIndex.from_bwa(index["tidx"])
    assert all(getattr(T, f) is None for f in FM_FIELDS)
    assert torch.equal(T.ref_pack, index["T"].ref_pack)


def test_occ_all_and_bwt_char_every_rank(index):
    J, T = index["J"], index["T"]
    k = np.arange(T.seq_len + 2, dtype=np.int32)
    assert _eq(jfm.occ_all(J, jnp.asarray(k)), tfm.occ_all(T, torch.from_numpy(k)))
    rows = k[(k <= T.seq_len) & (k != T.primary)]
    assert _eq(jfm.bwt_char(J, jnp.asarray(rows)),
               tfm.bwt_char(T, torch.from_numpy(rows)))


@pytest.mark.parametrize("c", range(5))
@pytest.mark.parametrize("fn", ["backward_ext", "forward_ext"])
def test_extension(index, fn, c):
    """Random bi-intervals, 64 of them with k straddling primary, extended
    by base c (4 = N): k, l, s bit-equal."""
    J, T = index["J"], index["T"]
    rng = np.random.default_rng(c)
    n = T.seq_len
    k = rng.integers(0, n, 4000).astype(np.int32)
    k[:64] = T.primary - 32 + np.arange(64)
    s = np.minimum(rng.integers(0, 50, 4000), n + 1 - k).astype(np.int32)
    l = rng.integers(0, n, 4000).astype(np.int32)
    cc = np.full(4000, c, np.int32)
    got = getattr(tfm, fn)(T, tfm.BiInterval(*(torch.from_numpy(a) for a in
                                               (k, l, s))), torch.from_numpy(cc))
    want = getattr(jfm, fn)(J, jfm.BiInterval(*(jnp.asarray(a) for a in
                                                (k, l, s))), jnp.asarray(cc))
    assert all(_eq(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("dense", [True, False])
def test_sa_lookup(index, dense):
    J, T = (index["J"], index["T"]) if dense else (index["Jw"], index["Tw"])
    r = np.arange(1, T.seq_len + 1, dtype=np.int32)
    got = tseed.sa_lookup(T, torch.from_numpy(r))
    assert _eq(jfm.sa_lookup(J, jnp.asarray(r)), got)
    assert np.array_equal(got.numpy(), index["jsa"][1:])
    if not dense:
        assert torch.equal(fm_search.fm_sa_walk(T, torch.from_numpy(r)), got)


@pytest.mark.parametrize("n_ranks", [2**31, 6_200_000_001])
def test_from_bwa_fm_refuses_int32_overflow(n_ranks):
    """More than 2^31 - 1 ranks (the second: a whole human genome's FMD
    index) would wrap the int32 rank arithmetic: the constructor refuses
    such an index before it reads any array (a stub BWAIndex with only
    the counts)."""
    from types import SimpleNamespace

    stub = SimpleNamespace(L2=np.array([0, 0, 0, 0, n_ranks - 1], np.int64))
    with pytest.raises(ValueError, match="int32"):
        tfm.FMIndex.from_bwa_fm(stub, sa_full=np.zeros(1, np.int64))


@pytest.mark.parametrize("stride,min_seed_len,dense", [
    (8, 19, True), (8, 19, False), (5, 15, True)])
def test_find_seeds(index, batch, stride, min_seed_len, dense):
    J, T = (index["J"], index["T"]) if dense else (index["Jw"], index["Tw"])
    reads, lens = batch
    want = jseed.find_seeds(J, jnp.asarray(reads), jnp.asarray(lens),
                            stride=stride, min_seed_len=min_seed_len)
    got = tseed.find_seeds(T, torch.from_numpy(reads), torch.from_numpy(lens),
                           stride=stride, min_seed_len=min_seed_len)
    assert all(_eq(a, b) for a, b in zip(want, got))
    assert 0 < int(got.valid.sum()) and int(got.strand[got.valid].sum()) > 0


def test_fm_smem_twin_lanes(index, batch):
    """The kernel's twin gives SMEMs that are exact matches of the genome
    text at every hit (an oracle independent of the JAX package)."""
    T = index["T"]
    reads, lens = batch
    starts = tseed.grid(reads.shape[1], 8, "cpu")
    lanes = fm_search.fm_smem(T, torch.from_numpy(reads),
                              torch.from_numpy(lens), starts)
    text = _fmd_text(index["tidx"].pac)
    sa = index["jsa"]
    G = starts.shape[0]
    checked = 0
    for i in np.flatnonzero(lanes.alive0.numpy() & (lanes.s.numpy() > 0)):
        b = i // G
        qb, qe, k = int(lanes.qbeg[i]), int(lanes.qend[i]), int(lanes.k[i])
        pos = sa[k]
        assert np.array_equal(text[pos:pos + qe - qb], reads[b, qb:qe])
        checked += 1
    assert checked > 100


# ------------------------------------------------ fm_smem's edge cases

EDGE_READS = 20


@pytest.fixture(scope="module")
def edge(tmp_path_factory):
    """Both packages' FMD indexes of ``utils/fm_cases.py``'s two genomes."""
    d = tmp_path_factory.mktemp("tfmedge")
    out = {}
    for name, g in fm_cases.edge_genomes(seed=31).items():
        fa = str(d / f"{name}.fa")
        synth.write_fasta(fa, g)
        build_index(fa)
        out[name] = (g, jfm.FMIndex.from_bwa(jbwt.load_index(fa)),
                     tfm.FMIndex.from_bwa_fm(load_index(fa)))
    return out


class _StepLog:
    """Every extension step the twin's lanes take (lanes alive, at an ACGT
    base): the rank x the step extends, its mirror y, the size s and the
    base class, as ``fm_smem``'s kernel sees them (a forward step extends
    the mirror interval (l, k) by the complement)."""

    def __init__(self):
        self.steps, self.phase, self.alive0, self.alive = [], None, None, None

    def wrap(self, fn, phase):
        def step(fm, iv, c):
            ext = fn(fm, iv, c)
            if self.phase != phase:       # a phase's first step
                if phase == "fwd":
                    self.alive0 = iv.s > 0
                self.alive, self.phase = self.alive0.clone(), phase
            live = self.alive & (c < 4)
            x, y, cc = ((iv.l, iv.k, 3 - c) if phase == "fwd"
                        else (iv.k, iv.l, c))
            self.steps.append([t[live].to(torch.int64).numpy()
                               for t in (x, y, iv.s, cc)])
            self.alive = live & (ext.s > 0)
            return ext
        return step


_M32 = 0xFFFFFFFF
_LOW = 0x55555555


def _top_bases(v):
    t = np.clip(2 * v, 0, 32)
    return np.where(t == 0, 0, (_M32 << (32 - t)) & _M32)


def _class_bits(x, c):
    """(base == c, base above c) bits of words x, as the kernel's is_c and
    above_c (c = 1 the high bit, c = 2 high & low, c = 0 and 3 none)."""
    t = ~(x ^ (_LOW * c)) & _M32
    gor = np.where(c == 1, _M32, 0)
    gmask = np.where((c == 1) | (c == 2), _LOW, 0)
    return t & (t >> 1) & _LOW, (x >> 1) & (x | gor) & gmask


def _popc_pairs(bits):
    """Set bits of (..., n) low-bit masks, two words to a popcount."""
    pair = bits[..., 0::2] | ((bits[..., 1::2] << 1) & _M32)
    return np.bitwise_count(pair.astype(np.uint64)).astype(np.int64).sum(-1)


def _kernel_step_model(T, x, s, c):
    """``fm_search.cu:extend`` in numpy, bit for bit: (new size, c's occ
    below x, bases above c in the interval), the path each step takes (one
    half-block counted up or down, or a lookup at each end) and the rows."""
    occ = T.occ_ckpt.numpy().astype(np.int64)
    halves = T.bwt.numpy().view(np.uint32).astype(np.int64).reshape(-1, 2, 4)
    nb = halves.shape[0]
    stored = lambda k: np.clip(k - (k > T.primary), 0, T.seq_len)
    pick = lambda ck: np.take_along_axis(ck, c[:, None], 1)[:, 0]
    above_ck = lambda ck: np.where(c == 1, ck[:, 2] + ck[:, 3],
                                   np.where(c == 2, ck[:, 3], 0))
    i4 = np.arange(4)

    def load_half(r, reach):
        blk, w = r >> 7, r & 127
        down = (w >= 64) & (blk < (T.seq_len >> 7))
        upper = down | (w > 64)
        rows = halves[np.minimum(blk, nb - 1)]
        v = np.where((upper | (reach > 0))[:, None],
                     rows[np.arange(len(r)), upper.astype(np.int64)], 0)
        lo = np.where((upper & ~down)[:, None], rows[:, 0], 0)
        return dict(ck=occ[blk + down], v=v, lo=lo, a=w - 64 * upper,
                    down=down, upper=upper)

    def count_half(h, z):
        ma = _top_bases(h["a"][:, None] - 16 * i4)
        side = np.where(h["down"][:, None], ~ma & _M32, ma)
        rng = _top_bases(z[:, None] - 16 * i4) & ~ma & _M32
        eq, gt = _class_bits(h["v"], c[:, None])
        leq, lgt = _class_bits(h["lo"], c[:, None])
        extra = (h["upper"] & ~h["down"]).astype(np.int64)
        cs = _popc_pairs(eq & side) + extra * _popc_pairs(leq)
        gs = _popc_pairs(gt & side) + extra * _popc_pairs(lgt)
        sign = np.where(h["down"], -1, 1)
        return (pick(h["ck"]) + sign * cs, above_ck(h["ck"]) + sign * gs,
                _popc_pairs(eq & rng), _popc_pairs(gt & rng))

    r1, r2 = stored(x), stored(x + s)
    e = r2 - ((r1 >> 7) << 7)
    p = load_half(r1, e)
    one = e <= np.where(p["upper"], 128, 64)
    occ1, og1, n, up = count_half(p, np.where(one, e - 64 * p["upper"],
                                              p["a"]))
    q = load_half(r2, r2 & 127)
    occ2, og2, _, _ = count_half(q, q["a"])
    n = np.where(one, n, occ2 - occ1)
    up = np.where(one, up, og2 - og1)
    up = np.where(c == 0, r2 - r1 - n, up)
    path = np.where(one, np.where(p["down"], "down", np.where(
        p["upper"], "partial", "up")), "two")
    return n, occ1, up, path, dict(r1=r1, r2=r2, blk=r1 >> 7, w1=r1 & 127,
                                   e=e, nb=nb)


def _count_step(T, x, y, s, c):
    """The twin's extension of (x, y, s) by c: (new size, c's occ below x,
    bases above c in the interval), from ``backward_ext_all``."""
    t = lambda a: torch.from_numpy(a)
    ext = tfm.backward_ext_all(T, tfm.BiInterval(t(x), t(y), t(s)))
    pick = lambda a: np.take_along_axis(a.numpy().astype(np.int64),
                                        c[:, None], 1)[:, 0]
    sent = ((T.primary >= x) & (T.primary < x + s)).astype(np.int64)
    return (pick(ext.s), pick(ext.k) - T.count.numpy()[c],
            pick(ext.l) - y - sent)


@pytest.mark.parametrize("L", fm_cases.WIDTHS)
@pytest.mark.parametrize("genome", ["random", "tandem"])
def test_fm_smem_edge_cases(edge, genome, L, monkeypatch):
    """``find_seeds`` at every anchor (stride 1) on ``utils/fm_cases.py``'s
    reads, the twin's against the JAX package's, every SMEM kept (min
    length 1, no occurrence cap); then every extension step the twin's
    lanes took, counted by a numpy model of the kernel's step (one
    half-block up or down, or two lookups; the class bits and paired
    popcounts) equal to the twin's count, and the steps reach each of the
    kernel's branches: the lower half, the upper half, the partial last
    block's upper half (counted up) and two lookups, two lookups inside one
    block, intervals holding the sentinel row in one block and across
    blocks, within 0 / 16 / 64 / 127, the last block and its last row."""
    g, J, T = edge[genome]
    reads, lens = fm_cases.edge_reads(g, L, EDGE_READS, seed=L)
    kw = dict(stride=1, min_seed_len=1, max_occ=1 << 30)
    want = jseed.find_seeds(J, jnp.asarray(reads), jnp.asarray(lens), **kw)
    log = _StepLog()
    monkeypatch.setattr(fm_search, "forward_ext",
                        log.wrap(fm_search.forward_ext, "fwd"))
    monkeypatch.setattr(fm_search, "backward_ext",
                        log.wrap(fm_search.backward_ext, "bwd"))
    got = tseed.find_seeds(T, torch.from_numpy(reads), torch.from_numpy(lens),
                           **kw)
    assert all(_eq(a, b) for a, b in zip(want, got))
    assert int(got.valid.sum()) > 0

    x, y, s, c = (np.concatenate(a) for a in zip(*log.steps))
    n, occ, up, path, at = _kernel_step_model(T, x, s, c)
    wn, wocc, wup = _count_step(T, x, y, s, c)
    assert np.array_equal(n, wn)
    ok = n > 0                     # the kernel keeps k and l otherwise
    assert np.array_equal(occ[ok], wocc[ok])
    assert np.array_equal(up[ok], wup[ok])

    same = (at["r1"] >> 7) == (at["r2"] >> 7)
    sent = (T.primary >= x) & (T.primary < x + s)
    reached = {
        "lower half": path == "up", "upper half": path == "down",
        "partial last block, upper half": path == "partial",
        "two blocks": (path == "two") & ~same,
        "two lookups in one block": (path == "two") & same,
        "sentinel, one block": sent & same, "sentinel, two blocks":
        sent & ~same, "last block": at["blk"] == at["nb"] - 1,
        "last row": at["r2"] == T.seq_len,
        "to the block's end": at["e"] == 128,
        **{f"within {w}": at["w1"] == w for w in (0, 16, 64, 127)}}
    assert not [k for k, m in reached.items() if not m.any()]


@pytest.mark.parametrize("genome", ["random", "tandem"])
def test_occ_checkpoints_count_their_blocks(edge, genome):
    """The identity the kernel's downward count rests on: checkpoint b+1
    is checkpoint b plus block b's counts, for every full block (the
    partial last block is only counted up)."""
    _, _, T = edge[genome]
    words = T.bwt.numpy().view(np.uint32)
    codes = (words[..., None] >> (30 - 2 * np.arange(16, dtype=np.uint32))
             ) & 3
    codes = codes.reshape(len(words), 128)[: T.seq_len >> 7]
    counts = np.stack([(codes == b).sum(1) for b in range(4)], 1)
    occ = T.occ_ckpt.numpy()
    assert np.array_equal(occ[1:len(counts) + 1] - occ[:len(counts)], counts)
    assert T.seq_len % 128 > 64 and occ[-1].sum() == T.seq_len


# ------------------------------------------------ fm_sa_walk's records

@pytest.fixture(scope="module")
def last_rank(tmp_path_factory):
    """The port's FMD index of ``fm_cases.last_rank_genome``: whole occ
    blocks only, and the sentinel rank last (primary == seq_len)."""
    fa = str(tmp_path_factory.mktemp("tfmlast") / "g.fa")
    synth.write_fasta(fa, fm_cases.last_rank_genome(seed=41))
    build_index(fa)
    T = tfm.FMIndex.from_bwa_fm(load_index(fa))
    assert T.primary == T.seq_len and T.seq_len % 128 == 0
    return T


def _walk_indexes(index, edge, last_rank):
    """(name, index with its walk records, full SA) of the test index, both
    edge genomes (their last occ block partial: 16 rows, and 90 rows with
    an upper half) and the last-rank genome (no partial block, primary ==
    seq_len)."""
    Tw = index["Tw"]
    out = [("test", Tw._replace(walk_rec=tfm.walk_records(Tw)),
            index["jsa"])]
    for name, T in (("random", edge["random"][2]),
                    ("tandem", edge["tandem"][2]), ("last rank", last_rank)):
        out.append((name, T._replace(walk_rec=tfm.walk_records(T)),
                    T.sa_dense.numpy().astype(np.int64)))
    return out


def _codes(T):
    words = T.bwt.numpy().view(np.uint32)
    return ((words[..., None] >> (30 - 2 * np.arange(16, dtype=np.uint32)))
            & 3).reshape(-1)[: T.seq_len].astype(np.int64)


def _walk_model(T, ranks):
    """``fm_search.cu``'s walk in numpy, reading only the records (and the
    SA samples at the end), bit for bit: (SA values, the census of what
    the steps reached)."""
    rec = T.walk_rec.numpy().view(np.uint32).astype(np.int64)
    count = T.count.numpy().astype(np.int64)
    full = T.seq_len >> 7
    r = ranks.astype(np.int64)
    steps = np.zeros_like(r)
    live = np.ones(len(r), bool)
    seen = {k: False for k in ("lower half", "upper half",
                               "partial block, lower", "partial block, upper",
                               "sentinel rank", "sentinel past the last row",
                               "marked at the start", "31 steps")}
    for it in range(32):
        kk = r - (r > T.primary)
        seen["sentinel past the last row"] |= bool(
            (live & (kk == T.seq_len)).any())
        blk, w = kk >> 7, kk & 127
        row = rec[blk]
        up = w >= 64
        half = np.where(up[:, None], row[:, 8:12], row[:, 4:8])
        mark = row[np.arange(len(r)), 12 + (w >> 5)]
        marked = (r == T.primary) | (((mark >> (w & 31)) & 1) == 1)
        seen["sentinel rank"] |= bool((live & (r == T.primary)).any())
        if it == 0:
            seen["marked at the start"] = bool(marked.any())
        live &= ~marked
        a = w & 63
        word = half[np.arange(len(r)), a >> 4]
        c = (word >> (30 - 2 * (a & 15))) & 3
        m = np.where(blk < full, 64, min(64, T.seq_len & 127))
        lo, hi = np.where(up, 0, a), np.where(up, a, m)
        i4 = 16 * np.arange(4)
        rng = (_top_bases(hi[:, None] - i4)
               & ~_top_bases(lo[:, None] - i4) & _M32)
        eq, _ = _class_bits(half, c[:, None])
        n = np.bitwise_count((eq & rng).astype(np.uint64)).astype(
            np.int64).sum(1)
        occ = np.take_along_axis(row[:, :4], c[:, None], 1)[:, 0] + np.where(
            up, n, -n)
        for k, at in (("lower half", ~up), ("upper half", up),
                      ("partial block, lower", ~up & (blk == full)),
                      ("partial block, upper", up & (blk == full))):
            seen[k] |= bool((live & at).any())
        r = np.where(live, count[c] + occ, r)
        steps += live
        if not live.any():
            break
    seen["31 steps"] = bool((steps == 31).any())     # the longest walk
    mk = T.sa_mark.numpy().view(np.uint32).astype(np.int64)[r >> 5]
    below = (np.int64(1) << (r & 31)) - 1
    at = T.sa_ckpt.numpy()[r >> 5] + np.bitwise_count(
        (mk & below).astype(np.uint64)).astype(np.int64)
    sa = T.sa_vals.numpy()[np.clip(at, 0, T.sa_vals.shape[0] - 1)] + steps
    return sa, seen


def test_walk_records(index, edge, last_rank):
    """The walk's records against the index's arrays, built here from the
    BWT codes and the full SA: per block the counts below its middle row
    (min(128 b + 64, seq_len)), its 8 BWT words, and the SA mark bits of
    its stored rows (stored row kk is rank kk + (kk >= primary)); then one
    zero record, which the sentinel rank's load reads where primary ==
    seq_len fills the last block."""
    for name, T, sa in _walk_indexes(index, edge, last_rank):
        rec = T.walk_rec.numpy()
        nb = T.bwt.shape[0]
        assert rec.shape == (nb + 1, tfm.WALK_REC_INTS), name
        assert rec.dtype == np.int32 and not rec[nb].any(), name
        rec = rec[:nb]
        codes = _codes(T)
        mid = np.minimum(128 * np.arange(nb) + 64, T.seq_len)
        below = np.stack([np.r_[0, np.cumsum(codes == c)][mid]
                          for c in range(4)], 1)
        assert np.array_equal(rec[:, :4], below), name
        assert np.array_equal(rec[:, 4:12], T.bwt.numpy()), name
        kk = np.arange(nb * 128)
        rank = kk + (kk >= T.primary)
        bit = np.zeros(nb * 128, np.uint64)
        ok = kk < T.seq_len
        bit[ok] = (sa[rank[ok]] % 32 == 0)
        words = (bit.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1)
        assert np.array_equal(rec[:, 12:].view(np.uint32).reshape(-1),
                              words.astype(np.uint32)), name
    # only a cuda index without the full SA carries them: the CPU walk is
    # the plain twin, which reads none
    assert index["T"].walk_rec is None and index["Tw"].walk_rec is None


def test_walk_kernel_model(index, edge, last_rank):
    """A numpy model of the walk kernel's steps, reading only the records,
    bit-equal to ``fm_sa_walk_plain`` and the full SA at every rank
    1..seq_len of the test index, both edge genomes and the last-rank
    genome, the ranks around the sentinel among them; the steps reach the
    lower and the upper half of full and partial blocks, the sentinel rank
    (also where it is seq_len, past the last stored row, in a whole last
    block) and 31-step walks."""
    reached = {}
    for name, T, sa in _walk_indexes(index, edge, last_rank):
        ranks = np.arange(1, T.seq_len + 1)
        got, seen = _walk_model(T, ranks)
        plain = fm_search.fm_sa_walk_plain(T, torch.from_numpy(ranks))
        assert np.array_equal(got, plain.numpy()), name
        assert np.array_equal(got, sa[1:]), name
        near = np.arange(T.primary - 2, T.primary + 3)
        near = near[(near >= 1) & (near <= T.seq_len)]
        assert np.array_equal(_walk_model(T, near)[0], sa[near]), name
        for k, v in seen.items():
            reached[k] = reached.get(k, False) or v
    assert not [k for k, v in reached.items() if not v]


def _planted_seeds(rng, B=64, S=24):
    """Seeds on four diagonals 4 kb apart (one chain each), all 20 bp at
    distinct read offsets, so chain weights are 20 × members and tie."""
    diag = rng.choice([1000, 5000, 9000, 13000], size=(B, S))
    qpos = np.tile(np.arange(S, dtype=np.int32) * 25 % 130, (B, 1))
    length = np.full((B, S), 20, np.int32)
    strand = rng.integers(0, 2, (B, S)).astype(np.int32)
    valid = rng.random((B, S)) < 0.6
    rpos = (diag + qpos - 151).astype(np.int32)
    return (rpos, qpos, length, strand,
            rng.integers(1, 5, (B, S)).astype(np.int32), valid)


def test_chain_seeds_planted_ties():
    cols = _planted_seeds(np.random.default_rng(11))
    want = jchain.chain_seeds(jseed.Seeds(*(jnp.asarray(c) for c in cols)),
                              151)
    got = tchain.chain_seeds(tseed.Seeds(*(torch.from_numpy(c) for c in cols)),
                             151)
    assert all(_eq(a, b) for a, b in zip(want, got))
    w = got.weight.numpy()
    assert ((w[:, 1:] == w[:, :-1]) & (w[:, 1:] > 0)).any(), "no tie planted"


def test_chain_seeds_of_found_seeds(index, batch):
    reads, lens = batch
    js = jseed.find_seeds(index["J"], jnp.asarray(reads), jnp.asarray(lens))
    ts = tseed.find_seeds(index["T"], torch.from_numpy(reads),
                          torch.from_numpy(lens))
    L = reads.shape[1]
    assert all(_eq(a, b) for a, b in
               zip(jchain.chain_seeds(js, L), tchain.chain_seeds(ts, L)))


def test_weight_candidates_fm_branch(index, batch):
    reads, lens = batch
    want = jcore.weight_candidates(index["J"], jnp.asarray(reads),
                                   jnp.asarray(lens), kidx=None)
    (got,) = tcore.weight_candidates(
        index["T"], [(torch.from_numpy(reads), torch.from_numpy(lens))])
    assert all(_eq(a, b) for a, b in zip(want, got))


def test_load_fm_caches_the_sa(tmp_path, monkeypatch):
    """fm: the full SA is reconstructed once and read back from the disk
    cache; hash: no SA, no FM arrays."""
    monkeypatch.setenv("HOME", str(tmp_path))
    g = synth.make_genome((3000, 2000, 1500), seed=2)
    fa = str(tmp_path / "g.fa")
    synth.write_fasta(fa, g)
    tpipe._host_cache.clear()
    idx, fm, kidx = tpipe._load_fm(fa, "cpu", "fm")
    assert kidx is None and fm.sa_dense is not None
    cache = tpipe._sa_cache_path(fa)
    assert os.path.exists(cache)
    want = suffix_array(_fmd_text(idx.pac))
    assert np.array_equal(np.load(cache), want)
    tpipe._host_cache.clear()
    _, fm2, _ = tpipe._load_fm(fa, "cpu", "fm")
    assert np.array_equal(fm2.sa_dense.numpy(), want)
    os.remove(cache)
    tpipe._host_cache.clear()
    _, fmh, kh = tpipe._load_fm(fa, "cpu", "hash")
    assert kh is not None and fmh.bwt is None and fmh.sa_dense is None
    assert not os.path.exists(cache)
    tpipe._host_cache.clear()


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def align_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfmalign")
    g = synth.make_genome(seed=11, n_del=12)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 360, read_len=100, seed=13, kill_frac=0.05,
                        protect_mod=BATCH)
    synth.write_fastq_pair(str(d / "r1.fq"), str(d / "r2.fq"), rd)
    return d, fa


@pytest.fixture(scope="module")
def both_runs(align_inputs):
    d, fa = align_inputs
    f1, f2 = str(d / "r1.fq"), str(d / "r2.fq")
    port = tpipe.align_fastq(
        fa, f1, f2, out_prefix=str(d / "port"),
        config=tpipe.AlignConfig(batch_size=BATCH, seed_mode="fm",
                                 insert_override=INSERT),
        device="cpu")
    mp = pytest.MonkeyPatch()
    oc, os_ = spl.sw_pallas_cigar, spl.sw_pallas
    mp.setattr(spl, "sw_pallas_cigar", no_kernel_nm(oc))
    mp.setattr(spl, "sw_pallas",
               lambda *a, interpret=False, **k: os_(*a, interpret=True, **k))
    mp.setattr(jpipe, "_pallas_ok", lambda: True)
    try:
        ref = jpipe.align_fastq(
            fa, f1, f2, out_prefix=str(d / "jax"),
            config=jpipe.AlignConfig(batch_size=BATCH, seed_mode="fm",
                                     insert_override=INSERT))
    finally:
        mp.undo()
    return ref, port


@pytest.mark.parametrize("out", OUTS)
def test_fm_align_record_equal(both_runs, align_inputs, out):
    """Record-equal, NM as tests/nm_recount.py holds it."""
    ref, port = both_runs
    genome = Genome(align_inputs[1])
    hj, rj = read_bam(ref[out])
    hp, rp = read_bam(port[out])
    strip = lambda t: [l for l in t.splitlines() if not l.startswith("@PG")]
    assert strip(hj.text) == strip(hp.text)
    assert len(rj) == len(rp) and rj
    for a, b in zip(rj, rp):
        assert_record_equal(a, b, genome)


def test_fm_cli_align_and_realign(align_inputs, tmp_path):
    """align --seed-mode fm on the CPU writes the triple of align_fastq;
    realign --seed-mode fm of it keeps every primary read."""
    d, fa = align_inputs
    pre = str(tmp_path / "cli")
    assert cli.main(["align", "-R", "@RG\\tID:1\\tSM:sample", "--seed-mode",
                     "fm", "--device", "cpu", "--batch-size", str(BATCH),
                     "-o", pre, fa, str(d / "r1.fq"), str(d / "r2.fq")]) == 0
    _, recs = read_bam(pre + ".bam")
    prim = {(r.qname, r.flag & 0xC0) for r in recs if not r.flag & 0x900}
    assert len(prim) == 720
    re_pre = str(tmp_path / "re")
    assert cli.main(["realign", "--seed-mode", "fm", "--device", "cpu",
                     "--batch-size", str(BATCH), "-o", re_pre, fa,
                     pre + ".bam"]) == 0
    _, out = read_bam(re_pre + ".bam")
    assert {(r.qname, r.flag & 0xC0) for r in out
            if not r.flag & 0x900} == prim
    assert all(os.path.exists(re_pre + s + ".bai") for s in
               (".bam", ".splitters.bam", ".discordants.bam"))
