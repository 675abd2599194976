"""sv's curve combination (``ops/sv_combine.py``) against the JAX package's
``_combine_jit``, on the CPU.

- ``cluster_and_combine`` on the CPU, whose member log-sum is the twin
  ``sv_combine_logsum_plain`` (captured at the wrapper: called once a side,
  no launch counted), followed by the rest of ``_combine``, against the
  JAX ``_combine_jit`` on the same cluster ids: pos, CI, CI95 and the live
  window equal, the curves within atol 2e-5 (tests/test_torch_sv.py's
  tolerance), on a pile of 4,096 members and on random many-cluster
  evidence, at trim 0 and 0.01;
- the twin's sums against a float64 statement of the same sums (within
  float32 rounding), members taken in row order from ``first``;
- the wrapper checks its inputs and refuses a device that is neither.
"""

import numpy as np
import pytest
import torch

from speedseq_tpu.sv import device as jdevice
from speedseq_tpu_torch.ops import sv_combine
from speedseq_tpu_torch.sv import device as tdevice
from speedseq_tpu_torch.sv.cluster import evidence_columns
from speedseq_tpu_torch.utils import sv_cases


def _evidence(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "pile":
        return sv_cases.pile_evidence(rng, 4096)
    return sv_cases.random_evidence(rng, 400)


def _captured_combine(cols, trim, monkeypatch):
    """cluster_and_combine on the CPU, with the wrapper's inputs kept."""
    seen = []
    real = sv_combine.combine_logsum

    def spy(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(sv_combine, "combine_logsum", spy)
    before = dict(sv_combine.LAUNCHES)
    cc = tdevice.cluster_and_combine(*cols, trim, device="cpu")
    assert sv_combine.LAUNCHES == before
    assert len(seen) == 2
    return cc, seen


@pytest.mark.parametrize("kind,seed,trim", [
    ("pile", 41, 0.0), ("pile", 41, 0.01), ("random", 23, 0.0),
    ("random", 5, 0.01)],
    ids=["pile-4096", "pile-4096-trim", "random-400", "random-400-trim"])
def test_combine_matches_jax(kind, seed, trim, monkeypatch):
    cols = evidence_columns(_evidence(kind, seed))[1:]
    gid, s1, l1, cur1, s2, l2, cur2 = cols
    cc, seen = _captured_combine(cols, trim, monkeypatch)
    C, W = cc.n_clusters, seen[0][6]
    assert (C == 1) == (kind == "pile") and C > 0
    for side, (s, ln, cur) in enumerate(((s1, l1, cur1), (s2, l2, cur2))):
        jprob, jints = (np.asarray(a) for a in jdevice._combine_jit(
            cc.cids.astype(np.int32), np.asarray(s, np.int32),
            np.asarray(ln, np.int32), np.asarray(cur, np.float32),
            np.float32(trim), n_seg=C, Wmax=W))
        np.testing.assert_array_equal(cc.pos[side], jints[:, 1])
        np.testing.assert_array_equal(cc.ci[side], jints[:, 2:4])
        np.testing.assert_array_equal(cc.ci95[side], jints[:, 4:6])
        np.testing.assert_array_equal(cc.nz[side], jints[:, 6:8])
        np.testing.assert_allclose(cc.prob[side], jprob, atol=2e-5, rtol=0)


def test_twin_sums_members_in_row_order(monkeypatch):
    cols = evidence_columns(_evidence("random", 11))[1:]
    _, seen = _captured_combine(cols, 0.0, monkeypatch)
    first, sizes, lo, start, clen, curves, W = seen[0]
    acc = sv_combine.sv_combine_logsum_plain(*seen[0]).numpy()
    cur = curves.numpy().astype(np.float64)
    want = np.zeros(acc.shape)
    for c in range(len(lo)):
        for row in range(int(first[c]), int(first[c] + sizes[c])):
            rel = np.arange(W) - (int(start[row]) - int(lo[c]))
            inside = (rel >= 0) & (rel < int(clen[row]))
            v = cur[row, np.clip(rel, 0, cur.shape[1] - 1)]
            want[c] += np.where(inside, np.log(np.maximum(v, 1e-12)),
                                np.log(np.float32(1e-12)))
    assert int(sizes.max()) > 1
    np.testing.assert_allclose(acc, want, rtol=1e-5, atol=1e-3)


def test_wrapper_checks_its_inputs():
    i = lambda *v: torch.tensor(v, dtype=torch.int32)
    first, sizes, lo = i(0, 2), i(2, 1), i(10, 40)
    start, clen = i(10, 12, 40), i(3, 2, 2)
    curves = torch.full((3, 3), 0.5)
    acc = sv_combine.combine_logsum(first, sizes, lo, start, clen, curves, 16)
    assert acc.shape == (2, 16)
    assert torch.equal(acc, sv_combine.sv_combine_logsum_plain(
        first, sizes, lo, start, clen, curves, 16))
    log_half, log_eps = np.log(np.float32(0.5)), np.log(np.float32(1e-12))
    np.testing.assert_allclose(acc[1, :2].numpy(), log_half, rtol=1e-6)
    np.testing.assert_allclose(acc[1, 2:].numpy(), log_eps, rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        sv_combine.combine_logsum(*(t.to("meta") for t in (
            first, sizes, lo, start, clen, curves)), 16)
    with pytest.raises(ValueError, match="one device"):
        sv_combine.combine_logsum(first, sizes, lo.to("meta"), start, clen,
                                  curves, 16)
    with pytest.raises(ValueError, match="first, sizes and lo"):
        sv_combine.combine_logsum(first[:1], sizes, lo, start, clen, curves,
                                  16)
    with pytest.raises(ValueError, match="W <="):
        sv_combine.combine_logsum(first, sizes, lo, start, clen, curves, 0)


# -------------------------------------------- the chunked kernel's model

SMS = 132          # the H100's SMs: the kernel narrows its tile below half


def _tile(C, W, sms=SMS):
    """csrc/sv_combine.cu's column tile: the widest of 128, 64, 32 and 16
    whose C x ceil(W / tile) blocks fill half the SMs, else 8."""
    for tw in (128, 64, 32, 16):
        if C * -(-W // tw) >= sms // 2:
            return tw
    return 8


def _chunk(tw):
    """Members a chunk of the kernel at a tile of tw columns: 4 a producer
    thread, the producers the block (256 threads at 128 columns, else
    1,024) less its adder warps."""
    B = 256 if tw == 128 else 1024
    return 4 * (B - max(tw, 32)) // tw


def _combine_kernel_model(first, sizes, lo, start, clen, curves, W):
    """csrc/sv_combine.cu:combine_logsum_kernel in numpy: a block a
    (cluster, tile of TW columns), the members in chunks of K (_chunk); a
    chunk's K x TW log values (torch.log, the function the twin and the
    card's logf compute, on the max with 1e-12, NaN kept; log(1e-12)
    outside a member's curve, the curve index clipped at D - 1) fill a
    buffer, then one float32 add a member a column, in row order, from
    0.0.  Returns (acc, TW)."""
    C, D = len(lo), curves.shape[1]
    tw = _tile(C, W)
    K = _chunk(tw)
    eps = np.float32(1e-12)
    log_eps = torch.log(torch.tensor(eps)).numpy()
    acc = np.zeros((C, W), np.float32)
    for c in range(C):
        m = int(sizes[c])
        for y in range(-(-W // tw)):
            w = y * tw + np.arange(tw)
            a = np.zeros(tw, np.float32)
            for ch in range(-(-m // K)):
                rows = int(first[c]) + ch * K + np.arange(min(K, m - ch * K))
                rel = w[None, :] - (start[rows] - int(lo[c]))[:, None]
                inside = (rel >= 0) & (rel < clen[rows][:, None])
                x = curves[rows[:, None], np.clip(rel, 0, D - 1)]
                x = np.where(np.isnan(x), x, np.maximum(x, eps))
                buf = np.where(inside, torch.log(torch.from_numpy(
                    np.ascontiguousarray(x))).numpy(), log_eps)
                for k in range(len(rows)):
                    a = (a + buf[k]).astype(np.float32)
            keep = w < W
            acc[c, w[keep]] = a[keep]
    return acc, tw


@pytest.mark.parametrize("case", sorted(sv_cases.COMBINE_EDGES))
def test_combine_kernel_model_matches_twin(case):
    """The chunked kernel's numpy model against the twin, bit for bit
    (NaN at the twin's NaN), at the chunk edges K - 1, K, K + 1 of each
    tile width, an empty cluster, a 4,096-member pile, W no multiple of
    the tile, and NaN, 0, negative, inf, denormal and <= 1e-12 curve
    values."""
    a = sv_cases.combine_edge_cases(case, seed=3)
    first, sizes, lo, start, clen, curves, W = a
    got, tw = _combine_kernel_model(*a)
    assert tw == {"tile-8": 8, "tile-16": 16, "tile-32": 32, "tile-64": 64,
                  "tile-128": 128, "pile-4096": 8}[case]
    K = _chunk(tw)
    assert {K - 1, K, K + 1, 0} <= set(sizes.tolist()) or case == "pile-4096"
    assert W % tw or case == "pile-4096"
    want = sv_combine.sv_combine_logsum_plain(
        *(torch.from_numpy(x) for x in a[:6]), W).numpy()
    # NaN where the twin has NaN (numpy and torch differ in NaN payloads
    # on the CPU), every other sum the same bits
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])
    assert nan.any() and (~nan).sum() > want.size // 2
    assert (want == 0).any() == (0 in sizes)


def test_combine_kernel_model_order_matters():
    """The model is sharp: adding a chunk's members in reverse order (the
    same values) breaks bit-equality on the pile."""
    a = sv_cases.combine_edge_cases("pile-4096", seed=3)
    a[5][np.isnan(a[5])] = 0.5          # NaN would hide any order
    want = sv_combine.sv_combine_logsum_plain(
        *(torch.from_numpy(x) for x in a[:6]), a[6]).numpy()
    got, _ = _combine_kernel_model(*a)
    np.testing.assert_array_equal(got, want)
    first, sizes = a[0], a[1]
    rev = list(a)
    rows = np.arange(int(sizes[0]))
    rows[:496] = rows[:496][::-1]
    for i in (3, 4, 5):
        rev[i] = a[i][rows]
    assert not np.array_equal(_combine_kernel_model(*rev)[0], want)
