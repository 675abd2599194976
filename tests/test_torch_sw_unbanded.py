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
- a numpy model of the CUDA kernel's thread layout (``_kernel_model``: C
  contiguous columns a thread, the shuffle scan of the thread maxima, the
  first maximal column by ballot, the loop ending at qlen) equal to the
  twin, at widths that are and are not multiples of 32; keep it in step
  with ``ops/csrc/sw_unbanded.cu`` when the kernel changes;
- the wrapper: the twin for a CPU tensor (no launch counted, at
  Lr > 1024 too), and a ValueError for a tensor on another device; the
  kernel's shape check (which the wrapper runs on a CUDA tensor) a
  ValueError for Lr > 1024 and Lq > Lr.
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
    """csrc/sw_unbanded.cu in numpy, all lanes at once: thread t of a warp
    holds columns [t C, t C + C), C the smallest template width >=
    ceil(Lr / 32); columns >= Lr are padding (H 0, never the first max)."""
    m, x, o, e = params
    N, Lq = q.shape
    Lr = r.shape[1]
    NEG = sw_unbanded.NEG
    C = next(w for w in WIDTHS if w >= -(-Lr // 32))
    j = np.arange(32 * C).reshape(32, C)
    real = j < Lr
    rc = np.full((N, 32 * C), 4, np.int64)
    rc[:, :Lr] = r
    rc = rc.reshape(N, 32, C)
    H = np.zeros((N, 32, C), np.int64)
    V = np.full((N, 32, C), NEG, np.int64)
    rows = np.minimum(ql, Lq)
    bs, bq, br, gs, gr = (np.zeros(N, np.int64) for _ in range(5))
    t = np.arange(32)
    for i in range(Lq):
        act = i < rows
        qc = q[:, i].astype(np.int64)[:, None, None]
        left = np.concatenate([np.zeros((N, 1), np.int64),
                               H[:, :-1, C - 1]], axis=1)     # shfl_up
        hprev = np.concatenate([left[:, :, None], H[:, :, :-1]], axis=2)
        sub = np.where((qc < 4) & (rc < 4), np.where(qc == rc, m, -x), -1)
        vr = np.maximum(V - e, H - o - e)
        ht = np.where(real, np.maximum(np.maximum(sub + hprev, vr), 0), 0)
        g = ht + e * j
        incl = g.max(axis=2)                         # thread maxima
        for d in (1, 2, 4, 8, 16):                   # shuffle scan
            y = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)
            incl = np.where(t >= d, np.maximum(incl, y), incl)
        pm = np.concatenate([np.full((N, 1), NEG, np.int64), incl[:, :-1]],
                            axis=1)
        # the exclusive prefix max within a thread's columns
        within = np.concatenate(
            [np.full((N, 32, 1), NEG, np.int64),
             np.maximum.accumulate(g, axis=2)[:, :, :-1]], axis=2)
        pmx = np.maximum(pm[:, :, None], within)
        h = np.where(real, np.maximum(ht, pmx - o - e * j), 0)
        tb = h.max(axis=2)
        tj = np.take_along_axis(np.broadcast_to(j, h.shape),
                                h.argmax(axis=2)[:, :, None], 2)[:, :, 0]
        rowmax = tb.max(axis=1)
        src = (tb == rowmax[:, None]).argmax(axis=1)   # __ffs of the ballot
        rj = tj[np.arange(N), src] + 1
        better = act & (rowmax > bs)
        bs, bq, br = (np.where(better, a, b) for a, b in
                      ((rowmax, bs), (i + 1, bq), (rj, br)))
        last = act & (ql == i + 1)
        gs, gr = np.where(last, rowmax, gs), np.where(last, rj, gr)
        H = np.where(act[:, None, None], h, H)
        V = np.where(act[:, None, None], vr, V)
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
    (300, 1024, BWA), (7, 9, BWA), (1, 1, BWA)],
    ids=["150x192", "250x320", "150x200-pad", "60x61-pad", "300x1024",
         "7x9", "1x1"])
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
    with pytest.raises(ValueError, match="Lr <= 1024"):
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
