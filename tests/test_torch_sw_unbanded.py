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
- a numpy model of the CUDA kernel's thread layout (``_kernel_model``:
  the column wavefront, R query rows a thread, the stripes' stored bottom
  row, the deletion state carried along the row, the one reduction of the
  best cell at the end) equal to the twin, at every row count a thread
  the kernel is built for, at widths that are and are not multiples of
  32, at stripe boundaries (Lq = 32 R and 32 R + 1), over several stripes
  and at Lr 1088, 2112 and 4160; each of its MUTATIONS must break it; keep
  it in step with ``ops/csrc/sw_unbanded.cu`` when the kernel changes;
- the wrapper: the twin for a CPU tensor (no launch counted, at
  Lr > 1024 too), and a ValueError for a tensor on another device; the
  width limit (``max_width``: 32,768 at bwa scoring, where the int32 key
  of the twin and the JAX scan stops being exact) a ValueError on every
  device; the kernel's shape check (which the wrapper runs on a CUDA
  tensor) a ValueError for Lq > Lr, past the width limit and for gap
  penalties below 0 only.
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


# changes to _kernel_model that must make it disagree with the twin
MUTATIONS = ("equal-max-later-row", "last-maximal-column", "g-past-Lq",
             "F-from-own-column")


def _kernel_model(q, ql, r, params, mutation=None, R=None):
    """csrc/sw_unbanded.cu:sw_unbanded_scan_kernel in numpy, all lanes at
    once.  ``scan_layout`` gives R rows a thread; a stripe of 32 R rows
    runs ceil(Lr / C) + 31 wavefront steps (C = SCAN_COLS), thread t on
    columns C (s - t) .. C (s - t) + C - 1 (skipped before the window;
    past it the diagonal is cut off); thread t takes the H above and its
    first row's V of those columns from thread t - 1 (thread 0 from the
    stripe above's stored bottom row, or the boundary), keeps the
    diagonal from the step before, and runs its R x C cells row by row
    with the deletion state F + e j carried along the row from H, V + e u
    carried down, and a row key h Lr + Lr - 1 - j.  After each stripe its
    rows join one reduction (largest max, then first row, in a 64-bit
    key); row qlen - 1 gives (gscore, grend).  The stripes run in order
    here; the kernel runs them on several warps, which changes no value.
    ``R`` overrides scan_layout's rows a thread (the wide entry takes any
    of SCAN_ROWS); ``mutation`` (one of MUTATIONS) breaks one of these on
    purpose."""
    m, x, o, e = params
    N, Lq = q.shape
    Lr = r.shape[1]
    NEG, C = sw_unbanded.NEG, sw_unbanded.SCAN_COLS
    R = R or sw_unbanded.scan_layout(Lq)[0]
    SR, oe = 32 * R, o + e
    t = np.arange(32)
    rows = np.minimum(ql, Lq).astype(np.int64)
    nstripes = np.where(rows > 0, -(-rows // SR), 0)
    top_v = max(NEG - e, -oe)
    q, r = q.astype(np.int64), r.astype(np.int64)
    best = np.zeros(N, np.int64)
    gs, gr = np.zeros(N, np.int64), np.zeros(N, np.int64)
    bufH = bufV = None
    z = lambda *shape: np.zeros(shape, np.int64)
    for k in range(int(nstripes.max(initial=0))):
        i = k * SR + t[:, None] * R + np.arange(R)[None, :]      # (32, R)
        qc = np.where(i < Lq, q[:, np.minimum(i, Lq - 1)], 4)     # (N, 32, R)
        qk, qm = np.where(qc < 4, qc, 5), np.where(qc < 4, 0, -1)
        H, F = z(N, 32, R), np.full((N, 32, R), NEG, np.int64)
        key = np.full((N, 32, R), -1, np.int64)
        outH, outV = z(N, Lr), z(N, Lr)
        upHd, botH = z(N, 32), z(N, 32, C)
        botV = np.full((N, 32, C), top_v, np.int64)
        for s in range(-(-Lr // C) + 31):
            upH = np.concatenate([z(N, 1, C), botH[:, :-1]], 1)
            upV = np.concatenate([z(N, 1, C), botV[:, :-1]], 1)
            for c in range(C):         # thread 0: the stripe above, or 0
                jc = C * s + c
                upH[:, 0, c] = bufH[:, jc] if k > 0 and jc < Lr else 0
                upV[:, 0, c] = (bufV[:, jc] if jc < Lr else 0) if k > 0 \
                    else top_v
            j0 = C * (s - t)                                        # (32,)
            act = (j0 >= 0) & (j0 < Lr)
            j = j0[:, None] + np.arange(C)[None, :]                 # (32, C)
            rc = np.where(j < Lr, r[:, np.clip(j, 0, Lr - 1)], 4)   # (N, 32, C)
            rk, misj = np.where(rc < 4, rc, 4), np.where(rc < 4, -x, -1)
            off = np.where(j < Lr, 0, NEG)
            ej = e * j
            ck = (j if mutation == "last-maximal-column" else Lr - 1 - j)
            hd0, hup, v = upHd, upH.copy(), upV.copy()
            for u in range(R):
                hd, hd0 = hd0, H[:, :, u].copy()
                f = F[:, :, u]
                kk = key[:, :, u]
                for c in range(C):
                    sub = np.where(qk[:, :, u] == rk[:, :, c], m,
                                   misj[:, :, c] | qm[:, :, u])
                    dg = hd + sub + off[:, c]
                    if mutation == "F-from-own-column":   # Ht(j), not j - 1
                        ht = np.maximum(np.maximum(dg, v[:, :, c] - e * u),
                                        0)
                        f = np.maximum(f, ht + ej[:, c] - oe)
                    y = np.maximum(np.maximum(dg, f - ej[:, c]), 0)
                    h = np.maximum(v[:, :, c] - e * u, y)
                    v[:, :, c] = np.maximum(y + e * (u + 1) - oe, v[:, :, c])
                    if mutation != "F-from-own-column":
                        f = np.maximum(h + ej[:, c] - o, f)
                    kk = np.maximum(kk, h * Lr + ck[:, c])
                    hd = hup[:, :, c].copy()
                    hup[:, :, c] = h
                a3 = act[None, :]
                H[:, :, u] = np.where(a3, hup[:, :, C - 1], H[:, :, u])
                F[:, :, u] = np.where(a3, f, F[:, :, u])
                key[:, :, u] = np.where(a3, kk, key[:, :, u])
            a4 = act[None, :, None]
            botH = np.where(a4, hup, botH)
            botV = np.where(a4, v - e * R, botV)
            if act[31]:                # thread 31 stores the bottom row
                cols = j[31][j[31] < Lr]
                outH[:, cols] = botH[:, 31, :len(cols)]
                outV[:, cols] = botV[:, 31, :len(cols)]
            upHd = upH[:, :, C - 1]
        bufH, bufV = outH, outV
        # the stripe's rows join the reduction
        rm, kc = key // Lr, key % Lr
        col = kc if mutation == "last-maximal-column" else Lr - 1 - kc
        rowkey = (65535 - i) if mutation != "equal-max-later-row" else i
        valid = i[None] < rows[:, None, None]
        pack = np.where(valid, (rm << 32) | (rowkey[None] << 16) | col, 0)
        best = np.maximum(best, pack.reshape(N, -1).max(axis=1))
        glast = (ql - 1 if mutation != "g-past-Lq" else rows - 1)
        at = valid & (i[None] == glast[:, None, None])
        has = at.reshape(N, -1).any(axis=1)
        gs = np.where(has, (rm * at).reshape(N, -1).sum(axis=1), gs)
        gr = np.where(has, ((col + 1) * at).reshape(N, -1).sum(axis=1), gr)
    bs = best >> 32
    row = (best >> 16) & 0xFFFF
    bq = np.where(bs > 0, row + 1 if mutation == "equal-max-later-row"
                  else 65536 - row, 0)
    br = np.where(bs > 0, (best & 0xFFFF) + 1, 0)
    g = (ql >= 1) & ((ql <= Lq) | (mutation == "g-past-Lq"))
    return [a.astype(np.int32) for a in (bs, bq, br, np.where(g, gs, 0),
                                         np.where(g, gr, 0))]


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


@pytest.mark.parametrize("Lq,Lr,params,R", [
    (150, 192, BWA, None), (250, 320, BWA, None), (150, 200, BWA, None),
    (60, 61, CHEAP_GAP, None), (300, 1024, BWA, None), (7, 9, BWA, None),
    (1, 1, BWA, None), (200, 1088, BWA, None), (200, 2112, CHEAP_GAP, None),
    (150, 4160, BWA, None), (90, 100, BWA, None), (180, 256, BWA, None),
    (256, 300, BWA, None), (257, 300, CHEAP_GAP, None),
    (1100, 1200, BWA, None), (192, 250, BWA, 6), (193, 250, BWA, 6),
    (129, 150, CHEAP_GAP, 4)],
    ids=["150x192", "250x320", "150x200-pad", "60x61-pad", "300x1024",
         "7x9", "1x1", "200x1088-wide", "200x2112-wide", "150x4160-wide",
         "R3-90x100", "R6-180x256-long-deletions", "one-stripe-256x300",
         "stripe-and-a-row-257x300", "five-stripes-1100x1200",
         "R6-one-stripe-192x250", "R6-stripe-and-a-row-193x250",
         "R4-stripes-129x150"])
def test_kernel_model_matches_twin(Lq, Lr, params, R):
    q, ql, r = (unbanded_lanes(Lq, Lr, seed=Lq + Lr) if Lr >= 150
                else _small_lanes(Lq, Lr, seed=Lq + Lr))
    _assert_equal(_kernel_model(q, ql, r, params, R=R),
                  _twin(q, ql, r, params), f"model {Lq}x{Lr}")


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_kernel_model_mutations_break_it(mutation):
    """Each of MUTATIONS makes the model disagree with the twin at 150 x
    256 (ties, deletions of 65 bases and more, and two lanes given a qlen
    past Lq)."""
    q, ql, r = unbanded_lanes(150, 256, seed=9)
    ql[[20, 60]] = (151, 155)
    got = _kernel_model(q, ql, r, BWA, mutation)
    want = _twin(q, ql, r, BWA)
    assert any((a != b).any() for a, b in zip(got, want)), mutation


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
    with pytest.raises(ValueError, match="gap open and extension >= 0"):
        sw_unbanded.check_kernel_shape(150, 192, (1, 4, -1, 1))
    with pytest.raises(ValueError, match="gap open and extension >= 0"):
        sw_unbanded.check_kernel_shape(150, 192, (1, 4, 6, -1))
    sw_unbanded.check_kernel_shape(150, 192, (1, 4, 0, 0))
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
    """scan_layout's stripes hold the query: one warp and one stripe of
    the fewest rows a thread up to 256 rows, above stripes of 256 rows on
    up to SCAN_WARPS warps; a block's stripe buffers (8 bytes a column a
    warp, rows padded to 4 columns) only where there are several stripes,
    beside its head, hand-off slots and window codes."""
    for Lq in (0, 1, 32, 33, 150, 192, 193, 200, 256):
        R, warps = sw_unbanded.scan_layout(Lq)
        assert warps == 1 and R in sw_unbanded.SCAN_ROWS
        assert 32 * R >= Lq and all(32 * x < Lq for x in
                                    sw_unbanded.SCAN_ROWS if x < R)
        assert sw_unbanded.scan_smem_bytes(Lq, 1088, R, warps) == (
            128 + 2048 + 4 * 1088, 0)
    for Lq, want in ((257, 2), (1000, 4), (1024, 4), (2000, 8),
                     (32768, 8)):
        assert sw_unbanded.scan_layout(Lq) == (8, want)
        assert sw_unbanded.scan_smem_bytes(Lq, 2111, 8, want) == (
            128 + 2048 * want + 4 * 2112, 8 * want * 2112)
    assert sw_unbanded.scan_layout(2000, warps=4) == (8, 4)
    # the narrow entry's widest block fits without a scratch
    assert sum(sw_unbanded.scan_smem_bytes(1024, 1024, 8, 4)) <= \
        sw_unbanded.SMEM_MAX
