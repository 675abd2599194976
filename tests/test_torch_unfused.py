"""The port's unfused alignment API against the JAX package's, on the CPU.

- (a) the traceback DP: the twin ``sw_cigar_unbanded_plain`` equal to the
  JAX ``banded_sw`` on all ten fields at (Lq, Lr) = (100, 204) and (150,
  254) on ``utils/var_cases.cigar_lanes`` (qlen 0, 1 and Lq; codes -1, 4
  and 5; two-letter ties; deletions of 65..200 columns, past the Pallas
  cap; I-runs; all-zero lanes; more than 48 ops) at bwa scoring, cheap
  gaps and a gap extension of 0; a numpy model of the CUDA kernel
  (``_cigar_kernel_model``: 8 columns a thread, the packed key's shuffle
  scan, the 4-bit codes of a row's words, the walk with the deletion
  source found by ballot over the record bits) equal to the twin; keep
  it in step with ``ops/csrc/sw_unbanded.cu:sw_unbanded_cigar_kernel``;
- (b) ``get_ref_window`` and ``read_kmers`` (k = 17, 19, 24, reads with N
  and out-of-range codes) equal to the JAX functions;
- (c) ``align_candidates`` on the CPU equal to the JAX one field for field
  on ``__graft_entry__._tiny_world``'s genome (20 kbp, 64 reads of 100
  bp, n_chains = 2), on the reads' mates and on 64 mutated reads
  (mismatches, indels, N bases, chimeras, short reads);
- (d) on those candidates ``choose_candidates``, ``select_alignments``,
  ``finalize_alignments`` (NM/MD from refwin and from ``host_ref``),
  ``assemble_records`` (paired and single-end; SAM records, splitters and
  discordants) and ``sort_key`` equal to the JAX package's;
- (e) the host cluster path ``_cluster_breakpoints_host`` equal to the
  JAX one and to the port's device sweep on the random evidence of
  tests/test_torch_sv.py.
"""

import collections
from typing import NamedTuple

import numpy as np
import pytest
import torch

from speedseq_tpu.align import core as jcore
from speedseq_tpu.align import pipeline as jpipe
from speedseq_tpu.align.markdup import StreamDupMarker as JDupMarker
from speedseq_tpu.align.pairing import InsertDistro as JDistro
from speedseq_tpu.align.sw import SWParams as JParams
from speedseq_tpu.align.sw import banded_sw as jax_banded_sw
from speedseq_tpu.index.bwt import build_index as jbuild_index
from speedseq_tpu.index.fm import FMIndex as JFMIndex
from speedseq_tpu.index.fm import get_ref_window as jget_ref_window
from speedseq_tpu.index.kmer import read_kmers as jread_kmers
from speedseq_tpu.sv import cluster as jcluster
from speedseq_tpu.utils.sim import simulate_pairs
from speedseq_tpu_torch.align import core as tcore
from speedseq_tpu_torch.align import pipeline as tpipe
from speedseq_tpu_torch.align.markdup import StreamDupMarker
from speedseq_tpu_torch.align.pairing import InsertDistro
from speedseq_tpu_torch.align.sw import SWParams, banded_sw
from speedseq_tpu_torch.formats.fasta import decode_bases
from speedseq_tpu_torch.index.bwt import build_index
from speedseq_tpu_torch.index.fm import FMIndex, get_ref_window
from speedseq_tpu_torch.index.kmer import read_kmers
from speedseq_tpu_torch.ops import sw_unbanded
from speedseq_tpu_torch.sv import cluster as tcluster
from speedseq_tpu_torch.utils import sv_cases
from speedseq_tpu_torch.utils.var_cases import cigar_lanes, cigar_run_lanes

BWA, CHEAP_GAP, EXT_0 = (1, 4, 6, 1), (1, 4, 1, 1), (1, 4, 6, 0)
FIELDS = ("score", "qbeg", "qend", "rbeg", "rend", "cigar_ops", "cigar_len",
          "n_ops", "gscore", "grend")
SHAPES = [(100, 204), (150, 254)]


# ----------------------------------------------------- (a) the traceback DP

def _np(out):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in out]


def _twin(q, ql, r, params):
    return _np(sw_unbanded.sw_cigar_unbanded_plain(
        *(torch.from_numpy(a) for a in (q, ql, r)), params))


def _assert_equal(got, want, what):
    for name, a, b in zip(FIELDS, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def jax_cigars():
    """The JAX banded_sw on cigar_lanes at each shape and scoring (one
    compile each)."""
    out = {}
    for Lq, Lr in SHAPES:
        lanes = cigar_lanes(Lq, Lr, seed=Lq)
        for params in (BWA, CHEAP_GAP, EXT_0):
            out[Lq, Lr, params] = lanes, _np(jax_banded_sw(
                *lanes, params=JParams(*params)))
    return out


@pytest.mark.parametrize("params", [BWA, CHEAP_GAP, EXT_0],
                         ids=["bwa", "cheap-gap", "ext-0"])
@pytest.mark.parametrize("Lq,Lr", SHAPES, ids=["100x204", "150x254"])
def test_twin_matches_jax_banded_sw(jax_cigars, Lq, Lr, params):
    (q, ql, r), want = jax_cigars[Lq, Lr, params]
    got = _twin(q, ql, r, params)
    _assert_equal(got, want, f"{Lq}x{Lr} {params}")
    assert got[5].dtype == np.int8 and want[5].dtype == np.int8
    # the lanes reach the corners they are there for
    assert {0, 1, Lq} <= set(ql.tolist())
    assert {-1, 4, 5} <= set(q.ravel().tolist()) & set(r.ravel().tolist())
    score, ops, lens, n_ops = got[0], got[5], got[6], got[7]
    assert (score == 0).sum() >= 2
    assert ((got[1] == 1) & (got[2] == 1) & (got[3] == 1)
            & (got[4] == 1))[score == 0].all()
    dels = np.where(ops == 2, lens, 0).max(axis=1)
    if Lq == 150 or params == EXT_0:    # where a long deletion pays
        assert (dels > 64).any()
    assert (np.where(ops == 1, lens, 0).max(axis=1) >= 8).any()
    if params == EXT_0:
        assert dels.max() >= 130
    if params == CHEAP_GAP:
        assert n_ops.max() > 48


def _cslot(i, w):
    """csrc/sw_unbanded.cu:cslot: row i's word w, rotated by the row."""
    return i * 32 + ((w + i) & 31)


MUTATIONS = ("run-in-mode-1", "unrotated-read", "first-record",
             "run-past-stop", "clipped-slot-reset", "window-edge-scores-1")


def _cigar_kernel_model(q, ql, r, params, max_ops=48, mutate=None,
                        census=None):
    """csrc/sw_unbanded.cu:sw_unbanded_cigar_kernel in numpy. Forward pass
    (cigar_row), all lanes at once: thread t holds columns [8 t, 8 t + 8),
    cells past the window run on unmasked, their diagonal step scoring
    OFF_WINDOW; the exclusive prefix max vmax of x = Ht + e j from a 5-step
    shuffle scan of the thread maxima and a serial max within the thread, F
    = vmax - o - e j; each row leaves one 32-bit word a thread of 4-bit
    codes, stored at ``_cslot(i, t)``: the direction from the sign bits of
    Z & (Y | ~X) and Z & X (X = diag - h, Y = V - h, Z = -h), the
    vertical-extend bit the sign of Hprev - Vprev - o - 1, the record bit x
    >= vmax; the row max and its first column from one max of h * 256 + 255
    - j. Then the walk, lane by lane, reading only that table: in mode 0 a
    diagonal run of the cells (i - t, j - t), t < 32, up to the first that
    is no diagonal step (a ballot), taken whole into the M op; then that
    cell, or in mode 1 the forced I step, as one step; a deletion's source
    is the last record column before j (a ballot over the row's words, the
    highest lane, its highest nibble). The op being written is kept apart
    and each finished op stored in its slot (clipped at max_ops - 1).
    ``mutate`` (one of MUTATIONS) breaks one rule; ``census`` counts the
    walk's branches."""
    m, x, o, e = params
    N, Lq = q.shape
    Lr = r.shape[1]
    NEG, C = sw_unbanded.NEG, 8
    msb = lambda v: (v < 0).astype(np.int64)        # a sign bit
    j = np.arange(32 * C).reshape(32, C)
    rc = np.full((N, 32 * C), 4, np.int64)
    rc[:, :Lr] = r
    rc = rc.reshape(N, 32, C)
    rk = np.where(rc < 4, rc, 4)                    # CigCols
    off = -(1 << 20)                                # OFF_WINDOW
    if mutate == "window-edge-scores-1":
        off = -1
    mis = np.where(j < Lr, np.where(rc < 4, -x, -1), off)
    H = np.zeros((N, 32, C), np.int64)
    V = np.full((N, 32, C), NEG, np.int64)
    rows = np.clip(ql, 0, Lq)
    table = np.zeros((N, Lq * 32), np.int64)
    bs, bi, bj, gs, gj = (np.zeros(N, np.int64) for _ in range(5))
    t = np.arange(32)
    for i in range(Lq):
        act = i < rows
        qc = q[:, i].astype(np.int64)[:, None, None]
        left = np.concatenate([np.zeros((N, 1), np.int64), H[:, :-1, C - 1]],
                              axis=1)                            # shfl_up
        hd = np.concatenate([left[:, :, None], H[:, :, :-1]], axis=2)
        sub = np.where(qc < 4, np.where(qc == rk, m, mis),
                       np.where(mis == off, off, -1))
        vx = H - V - (o + 1)
        vv = np.maximum(V - e, H - o - e)
        ht = np.maximum(np.maximum(hd + sub, vv), 0)
        xv = ht + e * j
        incl = xv.max(axis=2)
        for d in (1, 2, 4, 8, 16):
            y = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)
            incl = np.maximum(incl, y)
        vmax = np.concatenate([np.full((N, 1), NEG, np.int64),
                               incl[:, :-1]], axis=1)
        vm = np.maximum(vmax[:, :, None], np.concatenate(
            [np.full((N, 32, 1), NEG, np.int64),
             np.maximum.accumulate(xv, axis=2)[:, :, :-1]], axis=2))
        h = np.maximum(vm - o - e * j, ht)
        X, Y, Z = hd + sub - h, vv - h, -h
        nib = msb(Z & (Y | ~X)) | msb(Z & X) << 1 | msb(vx) << 2 | \
            msb(vm - xv - 1) << 3
        table[:, _cslot(i, t)] = np.where(
            act[:, None], (nib << (4 * np.arange(C))).sum(axis=2), 0)
        # no mask past the window: those cells stay at or below the real
        # row max (and lose its ties)
        P = (h * 256 + 255 - j).max(axis=(1, 2))       # __reduce_max_sync
        rowmax, rj = P >> 8, 255 - (P & 255)
        better = act & (rowmax > bs)
        bs, bi, bj = (np.where(better, a, b)
                      for a, b in ((rowmax, bs), (i, bi), (rj, bj)))
        last = act & (i == rows - 1)
        gs, gj = np.where(last, rowmax, gs), np.where(last, rj, gj)
        H = np.where(act[:, None, None], h, H)
        V = np.where(act[:, None, None], vv, V)

    def cell(n, i, jv, rotated=True):
        slot = _cslot(i, jv >> 3) if rotated else i * 32 + (jv >> 3)
        return int(table[n, slot]) >> (4 * (jv & 7)) & 15

    qbeg, rbeg, n_ops = (np.zeros(N, np.int64) for _ in range(3))
    ops_o = np.full((N, max_ops), -1, np.int64)
    lens_o = np.zeros((N, max_ops), np.int64)
    for n in range(N):
        i, jv, mode, kop, last_op = int(bi[n]), int(bj[n]), 0, 0, -1
        slots = {}                       # finished ops: slot -> (op, len)
        cur = [-1, 0]                    # the op being written

        def emit(op, ln):
            nonlocal kop, last_op
            if kop > 0 and op == last_op:
                cur[1] += ln
                return
            if kop >= max_ops and mutate != "clipped-slot-reset":
                cur[1] += ln
            elif kop >= max_ops:
                cur[1] = ln
            else:
                if kop > 0:
                    slots[kop - 1] = tuple(cur)
                cur[1] = ln
            cur[0] = last_op = op
            kop += 1

        limit, step = Lq + Lr, 0
        while bs[n] > 0 and step < limit:
            if mode == 0 or mutate == "run-in-mode-1":
                if mode == 0 and (i < 0 or jv < 0):
                    break
                cd = [cell(n, i - u, jv - u, mutate != "unrotated-read")
                      if i - u >= 0 and jv - u >= 0 else 0
                      for u in range(32)]
                stop = [u for u in range(32) if cd[u] & 3 != 1]  # ballot
                run = stop[0] if stop else 32
                if mutate == "run-past-stop" and 0 < run < 31:
                    run += 1
                mm = min(run, limit - step)
                if census is not None:
                    census["run longer than 32"] += run == 32 and \
                        cd[31] & 3 == 1 and i - 32 >= 0 and jv - 32 >= 0 \
                        and cell(n, i - 32, jv - 32) & 3 == 1
                    census["run stopped by a deletion"] += \
                        run < 32 and cd[run] & 3 == 3
                if mm > 0:
                    emit(0, mm)
                    i, jv, step = i - mm, jv - mm, step + mm
                if mm < run or run == 32:
                    continue
                code, d = cd[run], cd[run] & 3
                if d == 0:
                    break
            else:
                code = cell(n, min(max(i, 0), Lq - 1),
                            min(max(jv, 0), Lr - 1))
                d = 2
                if census is not None:
                    census["I step in mode 1"] += 1
            ln = 1
            if d == 3:
                below = jv - 8 * t
                keep = np.where(below <= 0, 0, np.where(
                    below < 8, (1 << (4 * np.clip(below, 0, 7))) - 1,
                    0xFFFFFFFF))
                words = table[n, _cslot(i, t)]
                recs = words & 0x88888888 & keep
                hold = np.flatnonzero(recs)                      # ballot
                gsrc = 0
                if len(hold):
                    w = hold.min() if mutate == "first-record" else hold.max()
                    bit = (int(recs[w]) & -int(recs[w])).bit_length() \
                        if mutate == "first-record" else \
                        int(recs[w]).bit_length()
                    gsrc = 8 * w + (bit - 1) // 4
                ln = max(min(max(jv - gsrc, 0), 255), 1)
            emit(d - 1, ln)
            mode = 1 if d == 2 and (code >> 2) & 1 else 0
            if d == 2:
                i -= 1
            else:
                jv -= ln
            step += 1
        if kop > 0:
            slots[min(kop - 1, max_ops - 1)] = tuple(cur)
        src = kop - 1 - np.arange(max_ops)
        for xo in np.flatnonzero(src >= 0):
            ops_o[n, xo], lens_o[n, xo] = slots[min(src[xo], max_ops - 1)]
        qbeg[n], rbeg[n], n_ops[n] = i + 1, jv + 1, kop
    return [bs, qbeg, bi + 1, rbeg, bj + 1, ops_o, lens_o, n_ops, gs,
            gj + 1]


@pytest.mark.parametrize("params", [BWA, CHEAP_GAP, EXT_0],
                         ids=["bwa", "cheap-gap", "ext-0"])
@pytest.mark.parametrize("Lq,Lr", SHAPES + [(7, 9), (1, 1), (40, 31),
                                    (300, 200), (1792, 256)],
                         ids=["100x204", "150x254", "7x9", "1x1",
                              "query-longer-40x31", "runs-300x200",
                              "runs-1792x256"])
def test_cigar_kernel_model_matches_twin(Lq, Lr, params):
    if Lq > Lr >= 150:  # runs longer than 32 rows, long I-runs
        q, ql, r = cigar_run_lanes(Lq, Lr, seed=Lq)
    elif Lr >= 150:
        q, ql, r = cigar_lanes(Lq, Lr, seed=Lq)
    else:               # two-letter lanes and codes -1..5, qlen -1..Lq + 1
        rng = np.random.default_rng(Lq + Lr)
        q = rng.integers(-1, 6, (48, Lq)).astype(np.int32)
        r = rng.integers(-1, 6, (48, Lr)).astype(np.int32)
        q[:24] = rng.integers(0, 2, (24, Lq))
        r[:24] = rng.integers(0, 2, (24, Lr))
        ql = rng.integers(-1, Lq + 2, 48).astype(np.int32)
    want = _twin(q, ql, r, params)
    _assert_equal(_cigar_kernel_model(q, ql, r, params), want,
                  f"model {Lq}x{Lr} {params}")


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_cigar_kernel_model_mutations_fail(mutate):
    """The model is sharp: each broken rule (a diagonal run taken in mode
    1, the table read without its rotation, a deletion's source at the
    first record, a run one cell past its stop, the clipped slot's length
    restarted, the cells past the window scoring -1 on the diagonal, so
    that the unmasked row max may land there) disagrees with the twin on
    cigar_lanes or cigar_run_lanes."""
    differ = []
    for f in (cigar_lanes, cigar_run_lanes):
        q, ql, r = f(150, 254, seed=150)
        want = _twin(q, ql, r, CHEAP_GAP)
        got = _cigar_kernel_model(q, ql, r, CHEAP_GAP, mutate=mutate)
        differ.append(not all(np.array_equal(a, b)
                              for a, b in zip(got, want)))
    assert any(differ)


def test_cigar_kernel_model_census():
    """The walk's branches that the lanes reach: diagonal runs longer than
    32 rows, runs stopped by a deletion, I steps forced by mode 1, more
    than 48 ops (the clipped slot)."""
    census = collections.Counter()
    for f, Lq, Lr in ((cigar_lanes, 150, 254), (cigar_run_lanes, 300, 200)):
        q, ql, r = f(Lq, Lr, seed=Lq)
        got = _cigar_kernel_model(q, ql, r, CHEAP_GAP, census=census)
        census["more than 48 ops"] += int((got[7] > 48).sum())
    assert all(census[k] > 0 for k in (
        "run longer than 32", "run stopped by a deletion",
        "I step in mode 1", "more than 48 ops")), dict(census)


def test_cigar_wrapper_runs_the_twin_on_cpu_and_checks_its_inputs():
    q, ql, r = (torch.from_numpy(a) for a in cigar_lanes(100, 204, seed=1))
    before = dict(sw_unbanded.LAUNCHES)
    got = banded_sw(q, ql, r, SWParams(*CHEAP_GAP))
    assert sw_unbanded.LAUNCHES == before
    _assert_equal(_np(got), _twin(q.numpy(), ql.numpy(), r.numpy(),
                                  CHEAP_GAP), "wrapper")
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="Lr <= 256"):
        sw_unbanded.sw_cigar_unbanded(z(2, 10), z(2), z(2, 257))
    with pytest.raises(ValueError, match="Lq >= 1"):
        sw_unbanded.sw_cigar_unbanded(z(2, 0), z(2), z(2, 200))
    # negative gap penalties: the twin takes them, the kernel does not
    sw_unbanded.check_cigar_shape(150, 254, 48, False, (1, 4, -1, 1))
    with pytest.raises(ValueError, match="gap open and extension"):
        sw_unbanded.check_cigar_shape(150, 254, 48, True, (1, 4, 6, -1))
    with pytest.raises(ValueError, match="unsupported device"):
        sw_unbanded.sw_cigar_unbanded(q.to("meta"), ql.to("meta"),
                                      r.to("meta"))
    assert sw_unbanded.LAUNCHES == before


# --------------------------------------------------- (b) windows and k-mers

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """__graft_entry__._tiny_world's genome and reads, indexed by both
    packages: (jax FMIndex, port FMIndex, port BWAIndex, JAX BWAIndex,
    genome, batches {name: (reads, lengths, quals)})."""
    d = tmp_path_factory.mktemp("unfused")
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    fa = str(d / "g.fa")
    seq = decode_bases(genome).decode()
    with open(fa, "w") as fh:
        fh.write(">g\n" + "".join(seq[i:i + 60] + "\n"
                                  for i in range(0, len(seq), 60)))
    jidx = jbuild_index(fa, write_files=False)
    tidx = build_index(fa, write_files=False)
    names, s1, q1, s2, q2, _ = simulate_pairs(genome, 64, read_len=100,
                                              seed=1)
    full = np.full(64, 100, np.int32)
    batches = {"reads": (s1.astype(np.int32), full, q1),
               "mates": (s2.astype(np.int32), full, q2),
               "mutated": _mutated_reads(genome, np.random.default_rng(7))}
    return (JFMIndex.from_bwa(jidx), FMIndex.from_bwa_fm(tidx), tidx, jidx,
            genome, batches, list(names))


def _mutated_reads(genome, rng, n=64, L=100):
    """(reads (n, L), lengths, quals): lane k % 8 is a clean read, 4
    mismatches, a 3-base insertion, a 5-base deletion, N bases, a chimera
    of two 50-base pieces 5 kbp apart, a read of 60..99 bases, or a
    reverse-complemented read with 2 mismatches and a 2-base deletion."""
    reads = np.full((n, L), 4, np.int32)
    lengths = np.full(n, L, np.int32)
    for k in range(n):
        p = int(rng.integers(100, len(genome) - 6_000))
        g = genome[p:p + L + 10].astype(np.int32)
        kind = k % 8
        if kind == 1:
            r = g[:L].copy()
            at = rng.choice(L, 4, replace=False)
            r[at] = (r[at] + 1) % 4
        elif kind == 2:
            r = np.concatenate([g[:50], rng.integers(0, 4, 3), g[50:]])
        elif kind == 3:
            r = np.concatenate([g[:45], g[50:]])
        elif kind == 4:
            r = g[:L].copy()
            r[rng.choice(L, 3, replace=False)] = 4
        elif kind == 5:
            r = np.concatenate([g[:50],
                                genome[p + 5_000:p + 5_050].astype(np.int32)])
        elif kind == 6:
            lengths[k] = int(rng.integers(60, L))
            r = g[:lengths[k]]
        elif kind == 7:
            r = np.concatenate([g[:30], g[32:]])[:L].copy()
            r[[10, 70]] = (r[[10, 70]] + 2) % 4
            r = np.where(r < 4, 3 - r, r)[::-1]
        else:
            r = g
        reads[k, :lengths[k]] = r[:lengths[k]]
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    return reads, lengths, quals


def test_get_ref_window_matches_jax(world):
    jfm, fm = world[0], world[1]
    starts = np.array([-300, -17, -1, 0, 5, 31, 1_000, 19_873, 19_950,
                       19_999, 20_000, 25_000], np.int32)
    for length in (1, 17, 204, 254):
        want = np.asarray(jget_ref_window(jfm, starts, length))
        got = get_ref_window(fm, torch.from_numpy(starts), length).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    two = starts.reshape(3, 4)
    np.testing.assert_array_equal(
        get_ref_window(fm, torch.from_numpy(two), 40).numpy(),
        np.asarray(jget_ref_window(jfm, two, 40)))


@pytest.mark.parametrize("k", [17, 19, 24])
def test_read_kmers_matches_jax(world, k):
    reads = np.concatenate([world[5]["mutated"][0][:24],
                            np.random.default_rng(k).integers(
                                -1, 7, (8, 100)).astype(np.int32)])
    want = [np.asarray(a) for a in jread_kmers(reads, k)]
    got = [a.numpy() for a in read_kmers(torch.from_numpy(reads), k)]
    assert (~want[2]).sum() > 1000 and want[2].sum() > 100
    for name, a, b in zip(("lo", "hi", "bad"), got, want):
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    with pytest.raises(ValueError, match="17..24"):
        read_kmers(torch.from_numpy(reads), 16)


# ------------------------------------------------- (c) align_candidates

CAND_FIELDS = ("pos", "strand", "score", "qbeg", "qend", "rend_pos",
               "cigar_ops", "cigar_len", "n_ops", "seed_cov", "refwin",
               "rstart", "nm")


@pytest.fixture(scope="module")
def candidates(world):
    """{batch: (JAX Candidates as numpy, port Candidates)}."""
    jfm, fm, batches = world[0], world[1], world[5]
    out = {}
    for name, (reads, lengths, _) in batches.items():
        want = jcore.align_candidates(jfm, reads, lengths, n_chains=2)
        got = tcore.align_candidates(fm, torch.from_numpy(reads),
                                     torch.from_numpy(lengths), n_chains=2)
        out[name] = (type(want)(*(np.asarray(a) for a in want)), got)
    return out


@pytest.mark.parametrize("batch", ["reads", "mates", "mutated"])
def test_align_candidates_matches_jax(candidates, batch):
    want, got = candidates[batch]
    for f in CAND_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    assert got.cigar_ops.dtype == torch.int8
    assert (want.nm == -1).all() and (want.score > 0).sum() >= 60
    if batch == "mutated":    # chimeras give a second chain of their own
        assert ((want.score[:, 1] >= 30) & (want.score[:, 0] >= 30)).sum() > 4


# ------------------------------------------------ (d) the host selection

class _NoWindow(NamedTuple):
    """A candidates view without refwin: finalize_alignments then reads
    NM/MD from ``host_ref``."""

    pos: np.ndarray
    strand: np.ndarray
    score: np.ndarray
    qbeg: np.ndarray
    qend: np.ndarray
    rend_pos: np.ndarray
    cigar_ops: np.ndarray
    cigar_len: np.ndarray
    n_ops: np.ndarray
    nm: np.ndarray


def _aln(a):
    return None if a is None else tuple(a)


def _assert_alignments(got, want, what):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (_aln(g[0]), _aln(g[1])) == (_aln(w[0]), _aln(w[1])), (what, k)


def _scored(cand, mod):
    """A ScoredChains of ``mod`` from candidates (numpy), as phase 1 would
    hand choose_candidates one."""
    c = {f: np.asarray(getattr(cand, f)) for f in CAND_FIELDS}
    return mod.ScoredChains(
        pos=c["pos"], rend_pos=c["rend_pos"], strand=c["strand"],
        score=c["score"], anchor_rpos=c["pos"] + 3, anchor_qpos=c["qbeg"],
        qspan_beg=c["qbeg"], qspan_end=c["qend"], qend=c["qend"],
        valid=c["score"] > 0)


@pytest.mark.parametrize("batch", ["reads", "mates", "mutated"])
def test_host_selection_matches_jax(world, candidates, batch):
    want_c, got_c = candidates[batch]
    reads, lengths, _ = world[5][batch]
    # select_alignments: the port fetches the tensors itself
    want = jcore.select_alignments(want_c, reads, lengths)
    got = tcore.select_alignments(got_c, torch.from_numpy(reads),
                                  torch.from_numpy(lengths))
    _assert_alignments(got, want, "select_alignments")
    assert sum(p.aligned for p, _ in got) >= 60
    assert any(p.md and "^" in p.md for p, _ in got) or batch != "mutated"
    if batch == "mutated":
        assert sum(s is not None for _, s in got) >= 4
    chosen = np.array([1 if k % 5 == 0 else 0 for k in range(len(reads))])
    _assert_alignments(
        tcore.select_alignments(got_c, reads, lengths, chosen_k=chosen,
                                find_splits=False),
        jcore.select_alignments(want_c, reads, lengths, chosen_k=chosen,
                                find_splits=False), "chosen_k")
    # choose_candidates on a phase-1 view of the same chains
    for ck in (None, chosen):
        a = jcore.choose_candidates(_scored(want_c, jcore), lengths,
                                    chosen_k=ck)
        b = tcore.choose_candidates(_scored(got_c, tcore), lengths,
                                    chosen_k=ck)
        for f, x, y in zip(b._fields, b, a):
            np.testing.assert_array_equal(x, y, err_msg=f)
    sel = tcore.choose_candidates(_scored(got_c, tcore), lengths)
    # finalize_alignments: refwin from the candidates, or host_ref
    want = jcore.finalize_alignments(want_c, reads, lengths, sel.sub,
                                     sel.sub_n)
    got = tcore.finalize_alignments(got_c, reads, lengths, sel.sub,
                                    sel.sub_n)
    _assert_alignments(got, want, "finalize_alignments")
    pac = np.asarray(world[2].pac)
    view = lambda c: _NoWindow(*(np.asarray(getattr(c, f))
                                 for f in _NoWindow._fields))
    want = jcore.finalize_alignments(view(want_c), reads, lengths, sel.sub,
                                     sel.sub_n, host_ref=pac)
    got_h = tcore.finalize_alignments(view(got_c), reads, lengths, sel.sub,
                                      sel.sub_n, host_ref=pac)
    _assert_alignments(got_h, want, "finalize_alignments host_ref")
    _assert_alignments(got_h, got, "host_ref against refwin")
    assert tcore.mapq_from_scores(90, 40, 2, 100) == \
        jcore.mapq_from_scores(90, 40, 2, 100)


def _rows(mod, sel, reads, lengths, quals, names, tag):
    rc = {0: "T", 1: "G", 2: "C", 3: "A", 4: "N"}
    rows = []
    for k, (prim, supp) in enumerate(sel):
        L = int(lengths[k])
        seq = "".join("ACGTN"[min(int(c), 4)] for c in reads[k, :L])
        qual = mod._phred(quals[k], L)
        rows.append(mod._PairRow(
            name=f"{names[k]}{tag}", seq=seq, qual=qual,
            seq_rc="".join(rc[min(int(c), 4)] for c in reads[k, :L][::-1]),
            qual_r=qual[::-1], aln=prim, supp=supp, tid=0,
            rg="grp" if k % 3 == 0 else ""))
    return rows


REC_FIELDS = ("qname", "flag", "tid", "pos", "mapq", "cigar", "mtid", "mpos",
              "tlen", "seq", "qual", "tags")


def _assert_records(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert [getattr(a, f) for f in REC_FIELDS] == \
            [getattr(b, f) for f in REC_FIELDS]


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
def test_assemble_records_matches_jax(world, candidates, paired):
    """Each package's records from its own selections: the reads with
    their mates (paired; read groups scoped to libraries) or alone, then
    the mutated reads (with themselves as mates when paired)."""
    names, batches = world[6], world[5]
    tags = ("/1" if paired else "", "/2", "m")
    out = []
    for mod, core, idx, k, distro, marker in (
            (tpipe, tcore, world[2], 1, InsertDistro, StreamDupMarker),
            (jpipe, jcore, world[3], 0, JDistro, JDupMarker)):
        rows = []
        for batch, tag in zip(("reads", "mates", "mutated"), tags):
            reads, lengths, quals = batches[batch]
            sel = core.select_alignments(candidates[batch][k], reads,
                                         lengths)
            rows.append(_rows(mod, sel, reads, lengths, quals, names, tag))
        cfg = mod.AlignConfig(rg_id="7")
        d = distro(300.0, 30.0, 150, 450)
        first = (mod.assemble_records(rows[0], rows[1], idx, d, cfg,
                                      marker=marker(), lib_of_rg={"grp": 1})
                 if paired else
                 mod.assemble_records(rows[2], None, idx, d, cfg,
                                      marker=marker()))
        out.append((first, mod.assemble_records(
            rows[2], rows[2] if paired else None, idx, d, cfg)))
    for got, want in zip(out[0], out[1]):
        for g, w in zip(got, want):     # main, splitters, discordants
            if w:
                _assert_records(g, w)
            else:
                assert g == []
        assert [tpipe.sort_key(r) for r in got[0]] == \
            [jpipe.sort_key(r) for r in want[0]]
        order = sorted(range(len(got[0])),
                       key=lambda i: tpipe.sort_key(got[0][i]))
        assert order == sorted(range(len(want[0])),
                               key=lambda i: jpipe.sort_key(want[0][i]))
    # the chimeras' splits reach the supplementary records and splitters
    (main, splitters, disc), (main2, splitters2, disc2) = out[0]
    n_supp = sum(bool(r.flag & 0x800) for r in main2)
    assert n_supp >= 8 and len(splitters2) >= n_supp
    assert all(any(t[0] == "MD" for t in r.tags) for r in main2
               if not r.flag & 0x4)
    if paired:
        assert len(main) == 128 and disc == [] and len(disc2) > 64
    else:
        assert len(splitters) >= 8
    assert tpipe._cigar_qspan([(4, 5), (0, 40), (1, 2), (2, 3), (4, 3)]) \
        == jpipe._cigar_qspan([(4, 5), (0, 40), (1, 2), (2, 3), (4, 3)])


# ------------------------------------------ (e) the host cluster path

def _assert_same_calls(got, want, exact):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in ("svtype", "tid1", "strand1", "pos1", "tid2", "strand2",
                  "pos2", "cipos", "ciend", "cipos95", "ciend95", "su", "pe",
                  "sr", "sample_support", "imprecise"):
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        for f in ("prpos", "prend"):
            if exact:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           atol=2e-5, rtol=0)


@pytest.mark.parametrize("seed,n,min_weight,trim,pile", [
    (11, 200, 2, 0.0, False), (5, 60, 1, 0.01, False),
    (23, 400, 1, 0.0, False), (41, 300, 4, 0.0, True)],
    ids=["200", "60-trim", "400", "pile-300"])
def test_host_cluster_path_matches_jax_and_the_sweep(seed, n, min_weight,
                                                      trim, pile):
    """The host path equal to the JAX one (curves too: the same float64
    numpy code); the device sweep (on the CPU) equal to it on random
    evidence within the JAX package's own device-against-host bar
    (tests/test_sv.py:361-384: curves within 2e-5).  The 300-member pile
    is held to the JAX host path only: its device curves sum 300 float32
    logs, which that bar does not cover."""
    rng = np.random.default_rng(seed)
    ev = (sv_cases.pile_evidence(rng, n) if pile
          else sv_cases.random_evidence(rng, n))
    got = tcluster._cluster_breakpoints_host(ev, min_weight=min_weight,
                                             trim=trim)
    want = jcluster._cluster_breakpoints_host(ev, min_weight=min_weight,
                                              trim=trim)
    _assert_same_calls(got, want, exact=True)
    assert [(b.start1, b.start2) for b in tcluster.cluster_order(ev)] == \
        [(b.start1, b.start2) for b in jcluster.cluster_order(ev)]
    if pile:
        assert len(got) == 1 and got[0].su == n
        return
    sweep = tcluster.cluster_breakpoints(ev, min_weight=min_weight,
                                         trim=trim, device="cpu")
    _assert_same_calls(sweep, got, exact=False)
