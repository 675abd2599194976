"""The unbanded score-only SW of var's haplotype scan
(``ops/sw_unbanded.py``) against the JAX package's ``banded_sw_score``, on
the CPU.

- the twin ``sw_score_unbanded_plain`` equal to the JAX scan on all five
  outputs at Lr 192, 320 and 1024, and at 1088 (1,000 bp reads, past the
  kernel's 1024: the twin takes any width, as the JAX scan does): edge
  cases, two-letter tie lanes, codes
  -1, 4 and 5 in query and window, qlen 0, 1 and Lq, and deletions longer
  than the Pallas kernels' 64-column cap;
- on those deletions the capped banded DP (``sw_banded.sw_score_plain``,
  the Pallas kernels' twin) scores lower: the cap is not the contract here;
- a numpy model of the CUDA kernels' thread layout (``_kernel_model``: C
  contiguous columns a thread, the shuffle scan of the thread maxima, the
  first maximal column by ballot, the loop ending at qlen; above 1,024
  columns the wide kernel's tiles, their row store and the values carried
  from tile to tile) equal to the twin, at widths that are and are not
  multiples of 32 and at Lr 1088, 2112 and 4160; keep it in step with
  ``ops/csrc/sw_unbanded.cu`` when the kernels change;
- the wrapper: the twin for a CPU tensor (no launch counted, at
  Lr > 1024 too), and a ValueError for a tensor on another device; the
  width limit (``max_width``: 32,768 at bwa scoring, where the int32 key
  of the twin and the JAX scan stops being exact) a ValueError on every
  device; the kernel's shape check (which the wrapper runs on a CUDA
  tensor) a ValueError for Lq > Lr and past the width limit only.
"""

import numpy as np
import pytest
import torch

from speedseq_tpu.align.sw import SWParams as JParams
from speedseq_tpu.align.sw import banded_sw_score as jax_sw_score
from speedseq_tpu_torch.align.sw import banded_sw_score
from speedseq_tpu_torch.ops import sw_banded, sw_unbanded
from speedseq_tpu_torch.utils.var_cases import hap_scan_lanes, unbanded_lanes

BWA, CHEAP_GAP = (1, 4, 6, 1), (1, 4, 1, 1)
FIELDS = ("score", "qend", "rend", "gscore", "grend")
# the template widths of csrc/sw_unbanded.cu (columns a thread)
WIDTHS = (2, 4, 6, 8, 10, 12, 16, 20, 24, 32)


def _jax(q, ql, r, params):
    out = jax_sw_score(q, ql, r, params=JParams(*params))
    return [np.asarray(a) for a in out]


def _twin(q, ql, r, params):
    return [t.numpy() for t in sw_unbanded.sw_score_unbanded_plain(
        torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(r),
        params)]


def _assert_equal(got, want, what):
    for name, a, b in zip(FIELDS, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("Lq,Lr,params", [
    (150, 192, BWA), (250, 320, BWA), (300, 1024, BWA),
    (250, 320, CHEAP_GAP), (1000, 1088, BWA)],
    ids=["150x192", "250x320", "300x1024", "250x320-cheap-gap",
         "1000x1088-past-the-kernel"])
def test_twin_matches_jax(Lq, Lr, params):
    q, ql, r = unbanded_lanes(Lq, Lr, seed=Lr)
    assert {0, 1, Lq} <= set(ql.tolist())
    assert {-1, 4, 5} <= set(q.ravel().tolist()) & set(r.ravel().tolist())
    _assert_equal(_twin(q, ql, r, params), _jax(q, ql, r, params),
                  f"{Lq}x{Lr}")


def test_long_deletions_pass_the_pallas_cap():
    """Deletions of 65 and 70 bases at 180 x 256 (the last two lanes): the
    unbanded DP (twin = JAX) joins the halves; the capped banded DP
    cannot."""
    q, ql, r = unbanded_lanes(180, 256, seed=3)
    q, ql, r = q[-2:], ql[-2:], r[-2:]
    want = _jax(q, ql, r, BWA)
    _assert_equal(_twin(q, ql, r, BWA), want, "long deletions")
    np.testing.assert_array_equal(want[0], 180 - (6 + np.array([65, 70])))
    capped = sw_banded.sw_score_plain(*(torch.from_numpy(a)
                                        for a in (q, ql, r)))
    assert (capped[0].numpy() < want[0]).all()


def _kernel_model(q, ql, r, params):
    """csrc/sw_unbanded.cu in numpy, all lanes at once.  Up to Lr = 1024
    (the narrow kernel) one tile: thread t of a warp holds columns
    [t C, t C + C), C the smallest template width >= ceil(Lr / 32).  Above
    (the wide kernel) ``wide_layout`` tiles of T = 32 C columns, walked in
    column order through a row store where column tile T + t C + k lives at
    slot tile T + 32 k + t, carrying the previous row's H left of the tile,
    the prefix max of Ht + e j and the row's first maximum.  Columns >= Lr
    are padding (H 0, never the first max)."""
    m, x, o, e = params
    N, Lq = q.shape
    Lr = r.shape[1]
    NEG = sw_unbanded.NEG
    if Lr <= sw_unbanded.MAX_LR:
        C, ntiles = next(w for w in WIDTHS if w >= -(-Lr // 32)), 1
    else:
        C, ntiles = sw_unbanded.wide_layout(Lr)
    T = 32 * C
    t = np.arange(32)
    slot = lambda tile: tile * T + 32 * np.arange(C)[None, :] + t[:, None]
    col = lambda tile: tile * T + t[:, None] * C + np.arange(C)[None, :]
    Hs = np.zeros((N, ntiles * T), np.int64)
    Vs = np.full((N, ntiles * T), NEG, np.int64)
    Rs = np.full((N, ntiles * T), 4, np.int64)
    for tile in range(ntiles):
        j = col(tile)
        Rs[:, slot(tile)] = np.where(j < Lr, r[:, np.minimum(j, Lr - 1)], 4)
    rows = np.minimum(ql, Lq)
    bs, bq, br, gs, gr = (np.zeros(N, np.int64) for _ in range(5))
    for i in range(Lq):
        act = i < rows
        qc = q[:, i].astype(np.int64)[:, None, None]
        hdiag = np.zeros(N, np.int64)
        pmc = np.full(N, NEG, np.int64)
        rb, rj = np.full(N, -1, np.int64), np.zeros(N, np.int64)
        for tile in range(ntiles):
            j, s = col(tile), slot(tile)
            real = j < Lr
            H, V, rc = Hs[:, s], Vs[:, s], Rs[:, s]
            left = np.concatenate([hdiag[:, None], H[:, :-1, C - 1]],
                                  axis=1)                       # shfl_up
            hdiag = H[:, 31, C - 1]
            hprev = np.concatenate([left[:, :, None], H[:, :, :-1]], axis=2)
            sub = np.where((qc < 4) & (rc < 4), np.where(qc == rc, m, -x),
                           -1)
            vr = np.maximum(V - e, H - o - e)
            ht = np.where(real, np.maximum(np.maximum(sub + hprev, vr), 0),
                          0)
            g = ht + e * j
            incl = g.max(axis=2)                     # thread maxima
            for d in (1, 2, 4, 8, 16):               # shuffle scan
                y = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)
                incl = np.where(t >= d, np.maximum(incl, y), incl)
            pm = np.concatenate([pmc[:, None], np.maximum(incl[:, :-1],
                                                          pmc[:, None])],
                                axis=1)
            pmc = np.maximum(pmc, incl[:, 31])
            # the exclusive prefix max within a thread's columns
            within = np.concatenate(
                [np.full((N, 32, 1), NEG, np.int64),
                 np.maximum.accumulate(g, axis=2)[:, :, :-1]], axis=2)
            pmx = np.maximum(pm[:, :, None], within)
            h = np.where(real, np.maximum(ht, pmx - o - e * j), 0)
            tb = h.max(axis=2)
            tj = np.take_along_axis(np.broadcast_to(j, h.shape),
                                    h.argmax(axis=2)[:, :, None], 2)[:, :, 0]
            tmax = tb.max(axis=1)
            src = (tb == tmax[:, None]).argmax(axis=1)  # __ffs of the ballot
            up = tmax > rb                     # a later tile: only larger
            rj = np.where(up, tj[np.arange(N), src], rj)
            rb = np.where(up, tmax, rb)
            Hs[:, s] = np.where(act[:, None, None], h, H)
            Vs[:, s] = np.where(act[:, None, None], vr, V)
        better = act & (rb > bs)
        bs, bq, br = (np.where(better, a, b) for a, b in
                      ((rb, bs), (i + 1, bq), (rj + 1, br)))
        last = act & (ql == i + 1)
        gs, gr = np.where(last, rb, gs), np.where(last, rj + 1, gr)
    return [a.astype(np.int32) for a in (bs, bq, br, gs, gr)]


def _small_lanes(Lq, Lr, seed):
    """Two-letter lanes and lanes of codes -1..5, qlen -1..Lq + 1."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, (32, Lq)).astype(np.int32)
    r = rng.integers(0, 2, (32, Lr)).astype(np.int32)
    q[16:] = rng.integers(-1, 6, (16, Lq))
    r[16:] = rng.integers(-1, 6, (16, Lr))
    ql = rng.integers(-1, Lq + 2, 32).astype(np.int32)
    ql[:3] = (0, 1, Lq)
    return q, ql, r


@pytest.mark.parametrize("Lq,Lr,params", [
    (150, 192, BWA), (250, 320, BWA), (150, 200, BWA), (60, 61, CHEAP_GAP),
    (300, 1024, BWA), (7, 9, BWA), (1, 1, BWA), (200, 1088, BWA),
    (200, 2112, CHEAP_GAP), (150, 4160, BWA)],
    ids=["150x192", "250x320", "150x200-pad", "60x61-pad", "300x1024",
         "7x9", "1x1", "200x1088-wide", "200x2112-wide", "150x4160-wide"])
def test_kernel_model_matches_twin(Lq, Lr, params):
    q, ql, r = (unbanded_lanes(Lq, Lr, seed=Lq + Lr) if Lr >= 150
                else _small_lanes(Lq, Lr, seed=Lq + Lr))
    _assert_equal(_kernel_model(q, ql, r, params),
                  _twin(q, ql, r, params), f"model {Lq}x{Lr}")


def test_kernel_model_matches_twin_on_hap_scan_lanes():
    q, ql, r = hap_scan_lanes(2)
    _assert_equal(_kernel_model(q, ql, r, BWA), _twin(q, ql, r, BWA),
                  "hap_scan_lanes")


def test_wrapper_runs_the_twin_on_cpu_and_checks_its_inputs():
    q, ql, r = (torch.from_numpy(a) for a in hap_scan_lanes(0))
    before = dict(sw_unbanded.LAUNCHES)
    got = banded_sw_score(q, ql, r)
    assert sw_unbanded.LAUNCHES == before
    _assert_equal([t.numpy() for t in got], _twin(*(
        a.numpy() for a in (q, ql, r)), BWA), "wrapper")
    wide = torch.zeros((2, 1025), dtype=torch.int32)
    got = sw_unbanded.sw_score_unbanded(q[:2], ql[:2], wide)
    assert sw_unbanded.LAUNCHES == before
    _assert_equal([t.numpy() for t in got], _twin(
        q[:2].numpy(), ql[:2].numpy(), wide.numpy(), BWA), "wide")
    sw_unbanded.check_kernel_shape(150, 1024)
    sw_unbanded.check_kernel_shape(150, 1025)
    with pytest.raises(ValueError, match="Lq <= Lr"):
        sw_unbanded.check_kernel_shape(150, 149)
    with pytest.raises(ValueError, match="Lr >= 1"):
        sw_unbanded.sw_score_unbanded(q[:2], ql[:2], wide[:, :0])
    with pytest.raises(ValueError, match="unsupported device"):
        sw_unbanded.sw_score_unbanded(q.to("meta"), ql.to("meta"),
                                      r.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        sw_unbanded.sw_score_unbanded(q, ql.to("meta"), r)


@pytest.mark.parametrize("params", [BWA, CHEAP_GAP, (2, 4, 6, 1),
                                    (1, 4, 6, 0)],
                         ids=["bwa", "cheap-gap", "match-2", "ext-0"])
def test_width_limit_is_where_the_key_stops_being_exact(params):
    """max_width is the largest Lr whose largest key (match Lr + e (Lr -
    1)) Lr + Lr - 1 fits int32; the kernel's shape check takes it and
    raises one column past it, and so does the CPU wrapper (the twin's
    key would wrap there, as the JAX scan's does)."""
    m, _, _, e = params
    top = sw_unbanded.max_width(params)
    key = lambda L: (m * L + e * (L - 1)) * L + L - 1
    assert key(top) <= 2 ** 31 - 1 < key(top + 1)
    if params == BWA:
        assert top == 32768
    sw_unbanded.check_kernel_shape(150, top, params)
    with pytest.raises(ValueError, match=f"Lr <= {top}"):
        sw_unbanded.check_kernel_shape(150, top + 1, params)
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    before = dict(sw_unbanded.LAUNCHES)
    with pytest.raises(ValueError, match=f"Lr <= {top}"):
        sw_unbanded.sw_score_unbanded(z(1, 4), z(1), z(1, top + 1), params)
    assert sw_unbanded.LAUNCHES == before


def test_wide_layout_tiles_hold_the_row():
    """Tiles of at most 1,024 columns, as few as hold the row, each of the
    fewest columns a thread that do."""
    for Lr in (1025, 1088, 2048, 2049, 2112, 3000, 4160, 32768):
        C, ntiles = sw_unbanded.wide_layout(Lr)
        assert C in sw_unbanded.WIDE_WIDTHS
        assert 32 * C * ntiles >= Lr > 32 * C * (ntiles - 1)
        assert ntiles == -(-Lr // 1024)
        assert all(32 * w * ntiles < Lr
                   for w in sw_unbanded.WIDE_WIDTHS if w < C)
