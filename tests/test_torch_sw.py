"""The port's banded Smith-Waterman twins (speedseq_tpu_torch.ops.sw_banded)
against the JAX package's Pallas kernels run in interpret mode, on seeded
edge-case sets: all 11 outputs of the traceback kernel and all 5 of the
score kernel bit-equal (ops/lens compared below n_ops); and a numpy model
of the score kernel's row step against both, on those sets and on
deletions at the deletion window's cap."""

import collections

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from speedseq_tpu.ops.sw_pallas import sw_pallas, sw_pallas_cigar
from speedseq_tpu_torch.ops import sw_banded
from speedseq_tpu_torch.utils.sw_cases import (N_KINDS, sw_cap_cases,
                                               sw_edge_cases)

CIGAR_OUT = ("score", "qbeg", "qend", "rbeg", "rend", "gscore", "grend",
             "ops", "lens", "n_ops", "nm")

# (Lq, params): the production read width with bwa scoring, and a narrower
# set with cheap gaps, where the alternating-indel lanes exceed 48 ops
SETS = [(151, (1, 4, 6, 1)), (112, (1, 4, 1, 1))]


@pytest.fixture(scope="module", params=SETS, ids=["Lq151-bwa", "Lq112-cheapgap"])
def case_set(request):
    Lq, params = request.param
    q, ql, r = sw_edge_cases(64, Lq, 256, seed=Lq)
    jq, jql, jr = jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r)
    ref_cigar = [np.asarray(a) for a in sw_pallas_cigar(
        jq, jql, jr, params=params, interpret=True)]
    ref_score = [np.asarray(a) for a in sw_pallas(
        jq, jql, jr, params=params, interpret=True)]
    tq, tql, tr = (torch.from_numpy(a) for a in (q, ql, r))
    # the cap-edge inputs at the same shape reuse the compiled program
    cap = sw_cap_cases(64, Lq, 256, seed=Lq + 1)
    cap_score = [np.asarray(a) for a in sw_pallas(
        *(jnp.asarray(a) for a in cap), params=params, interpret=True)]
    return dict(q=q, ql=ql, r=r, params=params, tq=tq, tql=tql, tr=tr,
                ref_cigar=ref_cigar, ref_score=ref_score, cap=cap,
                cap_score=cap_score)


def test_cigar_twin_matches_pallas(case_set):
    c = case_set
    got = [t.numpy() for t in sw_banded.sw_cigar_plain(
        c["tq"], c["tql"], c["tr"], c["params"])]
    n_ops = c["ref_cigar"][CIGAR_OUT.index("n_ops")]
    below = np.arange(48)[None, :] < n_ops[:, None]
    for name, want, have in zip(CIGAR_OUT, c["ref_cigar"], got):
        if name in ("ops", "lens"):
            want, have = np.where(below, want, 0), np.where(below, have, 0)
        assert np.array_equal(want, have), name


def test_score_twin_matches_pallas(case_set):
    c = case_set
    got = sw_banded.sw_score_plain(c["tq"], c["tql"], c["tr"], c["params"])
    for name, want, have in zip(("score", "qend", "rend", "gscore", "grend"),
                                c["ref_score"], got):
        assert np.array_equal(want, have.numpy()), name


def test_wrappers_take_the_twin_on_cpu(case_set):
    """On CPU tensors the wrappers run the twins and launch nothing."""
    c = case_set
    before = dict(sw_banded.LAUNCHES)
    a = sw_banded.sw_cigar(c["tq"], c["tql"], c["tr"], c["params"])
    b = sw_banded.sw_cigar_plain(c["tq"], c["tql"], c["tr"], c["params"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    s = sw_banded.sw_score(c["tq"], c["tql"], c["tr"], c["params"])
    assert all(torch.equal(x, y) for x, y in zip(
        s, sw_banded.sw_score_plain(c["tq"], c["tql"], c["tr"], c["params"])))
    assert sw_banded.LAUNCHES == before


def test_edge_cases_are_exercised(case_set):
    """The set really holds what it claims: dead lanes with the reference's
    packing-arithmetic outputs, more than 48 ops where gaps are cheap, and
    ties between equal placements."""
    c = case_set
    score, qbeg, qend, rbeg, rend, gscore, grend, ops, lens, n_ops, nm = \
        c["ref_cigar"]
    dead = c["ql"] == 0
    assert dead.any()
    assert (score[dead] == 0).all() and (qbeg[dead] == 1).all()
    assert (qend[dead] == 1).all() and (rend[dead] == 1).all()
    assert (grend[dead] == 256).all() and (n_ops[dead] == 0).all()
    lanes = np.arange(64)
    ties = lanes % N_KINDS == 9
    assert (score[ties] >= 40).all()
    if c["params"][2] == 1:
        assert (n_ops[lanes % N_KINDS == 10] == 48).any()
    # a deletion op and an insertion op both occur
    below = np.arange(48)[None, :] < n_ops[:, None]
    assert ((ops == 2) & below).any() and ((ops == 1) & below).any()


def test_non_cpu_tensor_never_takes_the_twin():
    """Only a CPU tensor runs the twin: any other device launches a kernel
    or raises (here a 'meta' tensor, which no kernel takes)."""
    q = torch.zeros((4, 151), dtype=torch.int32, device="meta")
    ql = torch.zeros(4, dtype=torch.int32, device="meta")
    r = torch.zeros((4, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw_banded.sw_cigar(q, ql, r)
    with pytest.raises(ValueError, match="unsupported device"):
        sw_banded.sw_score(q, ql, r)


# ------------------------------------------- the score kernel's row step
# A numpy model of ops/csrc/sw_banded.cu:sw_score_kernel in its own thread
# layout (32 lanes x 4 columns, arrays (N, 32, 4)): the PRMT substitution
# table, the window max from 11 shuffles, gbest from the last row and
# qlen < 1 apart.  Keep it in step with the kernel.

NEG = sw_banded.NEG


def _up(v, d):
    """__shfl_up_sync over the lane axis: a lane below d keeps its own."""
    u = v.copy()
    u[:, d:] = v[:, :-d]
    return u


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode) on int64 arrays of 32-bit words."""
    src = (b << 32) | a
    out = np.zeros_like(sel)
    for k in range(4):
        nib = (sel >> (4 * k)) & 0xF
        byte = (src >> (8 * (nib & 7))) & 0xFF
        byte = np.where(nib & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * k)
    return np.where(out >= 1 << 31, out - (1 << 32), out)


def _score_kernel_model(q, ql, r, params, census=None):
    p_match, p_mis, p_open, p_ext = params
    N, Lq = q.shape
    Lr = r.shape[1]
    lut = -128 <= p_match <= 127 and -127 <= p_mis <= 128
    # staging: selectors (or codes) of the window, the rows' tables
    win = np.full((N, 128 + 256), 4, np.int64)
    win[:, :Lr] = r
    win = np.where(win < 0, 5, np.minimum(win, 4))  # 4: N, 5: negative
    if lut:
        win = win * 0x1111 + 0x8880
        sub4 = np.where(q[..., None] < 4, np.where(
            np.arange(4) == q[..., None], p_match, -p_mis), -1)
        tab_a = ((sub4 & 0xFF) << (8 * np.arange(4))).sum(-1)
        tab_b = 0xFF | (np.where(q < 4, -p_mis, -1) & 0xFF) << 8
    lane = np.arange(32)[None, :, None]
    c = 4 * lane + np.arange(4)[None, None, :]
    H = np.zeros((N, 32, 4), np.int64)
    V = np.full((N, 32, 4), NEG, np.int64)
    bk = np.zeros((N, 32, 4), np.int64)
    K = (Lq + 1) * Lr
    rows = np.minimum(ql, Lq)
    up_or_neg = lambda v, d: np.where(lane[..., 0] < d, NEG, _up(v, d))
    n_idx = np.arange(N)[:, None, None]
    tie = {"best": np.full(N, -1), "split": np.zeros(N, bool)}
    for i in range(int(rows.max(initial=0))):
        act = (i < rows)[:, None, None]
        w = win[n_idx, i + c]
        qc = q[:, i][:, None, None]
        if lut:
            sub = _prmt(tab_a[:, i][:, None, None], tab_b[:, i][:, None, None],
                        w)
        else:
            sm = np.where(qc < 4, p_match, -1)
            smis = np.where(qc < 4, -p_mis, -1)
            sub = np.where(w == qc, sm, np.where(w == 4, -1, smis))
        Hup = np.roll(H[..., 0], -1, 1)
        Vup = np.roll(V[..., 0], -1, 1)
        Hup[:, 31], Vup[:, 31] = NEG, NEG
        Hv = np.concatenate([H[..., 1:], Hup[..., None]], -1)
        Vv = np.concatenate([V[..., 1:], Vup[..., None]], -1)
        Vn = np.maximum(Vv - p_ext, Hv - p_open - p_ext)
        Ht = np.maximum(np.maximum(H + sub, Vn), 0)
        x = Ht + p_ext * c
        x0, x1, x2, x3 = (x[..., t] for t in range(4))
        x01, x23 = np.maximum(x0, x1), np.maximum(x2, x3)
        m = np.maximum(x01, x23)
        m16, s1, s2, s3 = (up_or_neg(v, 16) for v in (
            m, np.maximum(x1, x23), x23, x3))
        B = np.maximum(np.maximum(up_or_neg(m, 1), up_or_neg(m, 2)),
                       np.maximum(up_or_neg(m, 3), up_or_neg(m, 4)))
        W = np.maximum(np.maximum(B, _up(B, 4)),
                       np.maximum(_up(B, 8), _up(B, 11)))
        pm = np.stack([np.maximum(W, m16), np.maximum(np.maximum(x0, W), s1),
                       np.maximum(np.maximum(x01, W), s2),
                       np.maximum(np.maximum(np.maximum(x01, x2), W), s3)],
                      -1)
        F = pm - p_open - p_ext * c
        Hn = np.maximum(Ht, F)
        if census is not None:
            _census_row(census, x, F, Ht, Hn, act, tie)
        R = K - 1 - i * (Lr + 1)
        H = np.where(act, Hn, H)
        V = np.where(act, Vn, V)
        bk = np.where(act, np.maximum(bk, Hn * K + R), bk)
    b = (bk - c).reshape(N, -1).max(1)
    b = np.where(ql < 1, Lq * Lr + Lr - 1 if Lq > 0 else 0, b)
    # gbest once, from the last row, where that row is qlen - 1
    g = (H * Lr + (Lr - ql[:, None, None] - c)).reshape(N, -1).max(1)
    g = np.where((ql >= 1) & (ql <= Lq), np.maximum(g, 0), 0)
    if census is not None:
        census["qlen = 0"] += int((ql < 1).sum())
        census["qlen = Lq"] += int((ql == Lq).sum())
        census["best row's score in two threads"] += int(
            (tie["split"] & (tie["best"] > 0)).sum())
    M = (Lq + 1) * Lr
    rem = b % M
    return (b // M, Lq - rem // Lr + 1, Lr - 1 - rem % Lr + 1, g // Lr,
            Lr - 1 - g % Lr + 1)


def _census_row(census, x, F, Ht, Hn, act, tie):
    """Cells where F decides H: in lanes below 16, in column t = 3, and
    at the cap (the window's maximum only at distance 64); and whether the
    first row to reach an alignment's best score reaches it in two
    threads."""
    N = x.shape[0]
    top = Hn.reshape(N, -1).max(1)
    new = act[:, 0, 0] & (top > tie["best"])
    threads = (Hn == top[:, None, None]).any(-1).sum(-1)
    tie["split"] = np.where(new, threads > 1, tie["split"])
    tie["best"] = np.where(new, top, tie["best"])
    flat = x.reshape(N, 128)
    dec = ((F > Ht) & act).reshape(N, 128)
    census["F decides, lane < 16"] += int(dec[:, :64].sum())
    census["F decides, t = 3"] += int(dec[:, 3::4].sum())
    pad = np.concatenate([np.full((N, 64), NEG, flat.dtype), flat], 1)
    near = np.stack([pad[:, 64 - k:192 - k] for k in range(1, 64)]).max(0)
    at64 = pad[:, :128]
    census["F decides at the cap"] += int((dec & (at64 > near)).sum())


@pytest.mark.parametrize("inputs", ["edge", "cap"])
def test_score_kernel_model(case_set, inputs):
    """The kernel's row step, modelled in its thread layout, is bit-equal
    to the twin and to the Pallas kernel (interpret mode), and the inputs
    run each of its branches."""
    c = case_set
    if inputs == "edge":
        q, ql, r, want = c["q"], c["ql"], c["r"], c["ref_score"]
    else:
        (q, ql, r), want = c["cap"], c["cap_score"]
    census = collections.Counter()
    got = _score_kernel_model(q.astype(np.int64), ql.astype(np.int64),
                              r.astype(np.int64), c["params"], census)
    twin = sw_banded.sw_score_plain(*(torch.from_numpy(a) for a in
                                      (q, ql, r)), c["params"])
    for name, a, b, t in zip(("score", "qend", "rend", "gscore", "grend"),
                             got, want, twin):
        assert np.array_equal(a, b), name
        assert np.array_equal(a, t.numpy()), name
    need = {"cap": ["F decides, t = 3", "qlen = Lq"],
            "edge": ["F decides, lane < 16", "F decides, t = 3",
                     "best row's score in two threads", "qlen = 0",
                     "qlen = Lq"]}[inputs]
    if inputs == "cap" and c["params"] == (1, 4, 6, 1):
        # with cheap gaps the cells right of a diagonal tie the cap column
        # (each loses one a column), so only bwa scoring decides there
        need.append("F decides at the cap")
    assert all(census[k] > 0 for k in need), dict(census)


@pytest.mark.parametrize("params", [(1, 4, 6, 1), (200, 300, 6, 1)],
                         ids=["int8-table", "compares"])
def test_score_kernel_model_both_substitutions(params):
    """Both substitution paths of the kernel (the int8 PRMT table, and
    compares where the scores do not fit int8) against the twin, with a
    qlen above Lq (rows capped, no gbest) and a negative one, and ref codes
    below 0 (a mismatch against every base) and above 4 (N)."""
    q, ql, r = sw_edge_cases(26, 48, 160, seed=5)
    q[0, :8], r[1, :8] = 4, 4
    ql[2], ql[3] = 48 + 5, -1
    rng = np.random.default_rng(5)
    odd = rng.random(r.shape) < 0.15
    odd[:4] = False
    r[odd] = rng.choice(np.array([-7, -1, 5, 9], np.int32), int(odd.sum()))
    r[4, :60] = -1  # a run of negative codes under a whole query
    got = _score_kernel_model(q.astype(np.int64), ql.astype(np.int64),
                              r.astype(np.int64), params)
    want = sw_banded.sw_score_plain(*(torch.from_numpy(a) for a in
                                      (q, ql, r)), params)
    for name, a, b in zip(("score", "qend", "rend", "gscore", "grend"), got,
                          want):
        assert np.array_equal(a, b.numpy()), name
