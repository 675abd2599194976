"""The port's banded Smith-Waterman twins (speedseq_tpu_torch.ops.sw_banded)
against the JAX package's Pallas kernels run in interpret mode, on seeded
edge-case sets: all 11 outputs of the traceback kernel and all 5 of the
score kernel bit-equal (ops/lens compared below n_ops); a numpy model of
the score kernel's row step against both, on those sets and on deletions
at the deletion window's cap; a numpy model of the traceback kernel (its
row with 4-bit direction codes and its warp-wide walk) against both, on
the edge cases and on chains longer than 127 rows; and NM held to the
cigar's edit distance, where the reference counts a long run's
mismatches twice."""

import collections

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from speedseq_tpu.ops.sw_pallas import sw_pallas, sw_pallas_cigar
from speedseq_tpu_torch.ops import sw_banded
from speedseq_tpu_torch.utils.sw_cases import (N_KINDS, sw_cap_cases,
                                               sw_edge_cases,
                                               sw_long_run_cases)

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
    # chains longer than 127 rows, Lq = Lr = 256
    long = sw_long_run_cases(64, 256, 256, seed=Lq + 2)
    long_cigar = [np.asarray(a) for a in sw_pallas_cigar(
        *(jnp.asarray(a) for a in long), params=params, interpret=True)]
    return dict(q=q, ql=ql, r=r, params=params, tq=tq, tql=tql, tr=tr,
                ref_cigar=ref_cigar, ref_score=ref_score, cap=cap,
                cap_score=cap_score, long=long, long_cigar=long_cigar)


def _check_nm(nm, pallas, q, r):
    """NM against the Pallas kernel's outputs ``pallas`` (its other fields
    already found equal): the cigar's edit distance on every lane whose
    ops did not overflow, and the Pallas NM wherever no M op is longer
    than the 127-row jump.  Where one is, the Pallas NM may only be higher
    (the reference counts some of that run's mismatches twice).  Returns
    the lanes where the two differ."""
    _, qbeg, _, rbeg, _, _, _, ops, lens, n_ops, pnm = pallas
    below = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    long_m = ((ops == 0) & below & (lens > 127)).any(1)
    exact = n_ops < ops.shape[1]
    for n in np.nonzero(exact)[0]:
        assert nm[n] == _edit_distance(q[n], r[n], qbeg[n], rbeg[n], ops[n],
                                       lens[n], n_ops[n]), n
    assert np.array_equal(nm[~long_m], pnm[~long_m])
    assert (pnm[long_m] >= nm[long_m]).all()
    return np.nonzero(nm != pnm)[0]


def test_cigar_twin_matches_pallas(case_set):
    """All fields but NM bit-equal to the Pallas kernel; NM held by
    _check_nm, on the edge cases and on the chains longer than 127 rows."""
    c = case_set
    for (q, ql, r), ref in (((c["q"], c["ql"], c["r"]), c["ref_cigar"]),
                            (c["long"], c["long_cigar"])):
        got = [t.numpy() for t in sw_banded.sw_cigar_plain(
            *(torch.from_numpy(a) for a in (q, ql, r)), c["params"])]
        n_ops = ref[CIGAR_OUT.index("n_ops")]
        below = np.arange(48)[None, :] < n_ops[:, None]
        for name, want, have in zip(CIGAR_OUT[:-1], ref, got):
            if name in ("ops", "lens"):
                want, have = np.where(below, want, 0), np.where(below, have, 0)
            assert np.array_equal(want, have), name
        _check_nm(got[-1], ref, q, r)


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


LANE = np.arange(32)[None, :, None]
COL = 4 * LANE + np.arange(4)[None, None, :]     # c = 4l + t


def _stage(q, r, params):
    """The kernels' staging: the window's selectors (or class codes: 4 N,
    5 negative) and each query row's table, as int64 arrays."""
    p_match, p_mis = params[:2]
    N = q.shape[0]
    lut = -128 <= p_match <= 127 and -127 <= p_mis <= 128
    win = np.full((N, 128 + 256), 4, np.int64)
    win[:, :r.shape[1]] = r
    win = np.where(win < 0, 5, np.minimum(win, 4))  # 4: N, 5: negative
    tab_a = tab_b = None
    if lut:
        win = win * 0x1111 + 0x8880
        sub4 = np.where(q[..., None] < 4, np.where(
            np.arange(4) == q[..., None], p_match, -p_mis), -1)
        tab_a = ((sub4 & 0xFF) << (8 * np.arange(4))).sum(-1)
        tab_b = 0xFF | (np.where(q < 4, -p_mis, -1) & 0xFF) << 8
    return lut, win, tab_a, tab_b


def _row_sub(lut, win, tab_a, tab_b, q, i, params):
    """Row i's substitution scores (N, 32, 4): one PRMT a cell, or
    compares."""
    p_match, p_mis = params[:2]
    w = win[np.arange(q.shape[0])[:, None, None], i + COL]
    if lut:
        return _prmt(tab_a[:, i][:, None, None], tab_b[:, i][:, None, None],
                     w)
    qc = q[:, i][:, None, None]
    sm = np.where(qc < 4, p_match, -1)
    smis = np.where(qc < 4, -p_mis, -1)
    return np.where(w == qc, sm, np.where(w == 4, -1, smis))


def _vertical(H, V, p_open, p_ext):
    """(Vv - e, H from the vertical neighbour - o - e): column c + 1 of
    the row above, lane l + 1's column 0 by a shuffle, NEG past 127."""
    Hup = np.roll(H[..., 0], -1, 1)
    Vup = np.roll(V[..., 0], -1, 1)
    Hup[:, 31], Vup[:, 31] = NEG, NEG
    Hv = np.concatenate([H[..., 1:], Hup[..., None]], -1)
    Vv = np.concatenate([V[..., 1:], Vup[..., None]], -1)
    return Vv - p_ext, Hv - p_open - p_ext


def _del_window(x, fill=None):
    """pm[c] = max x over [c-64, c-1] from 11 shuffles on 2 rounds (the
    window of csrc/sw_banded.cu:score_row); with ``fill``, a lane's missing
    neighbours get their own value plus fill, not NEG (del_window_pen)."""
    def up_or_neg(v, d):
        if fill is None:
            return np.where(LANE[..., 0] < d, NEG, _up(v, d))
        return _up(v, d) + np.where(LANE[..., 0] < d, fill, 0)

    x0, x1, x2, x3 = (x[..., t] for t in range(4))
    x01, x23 = np.maximum(x0, x1), np.maximum(x2, x3)
    m = np.maximum(x01, x23)
    m16, s1, s2, s3 = (up_or_neg(v, 16) for v in (
        m, np.maximum(x1, x23), x23, x3))
    B = np.maximum(np.maximum(up_or_neg(m, 1), up_or_neg(m, 2)),
                   np.maximum(up_or_neg(m, 3), up_or_neg(m, 4)))
    W = np.maximum(np.maximum(B, _up(B, 4)),
                   np.maximum(_up(B, 8), _up(B, 11)))
    return np.stack([np.maximum(W, m16), np.maximum(np.maximum(x0, W), s1),
                     np.maximum(np.maximum(x01, W), s2),
                     np.maximum(np.maximum(np.maximum(x01, x2), W), s3)],
                    -1)


def _decode_keys(bk, H, ql, Lq, Lr):
    """The best-cell key less its column term, and gbest from the last row
    where that row is qlen - 1; decoded as the kernels do."""
    N = bk.shape[0]
    b = (bk - COL).reshape(N, -1).max(1)
    b = np.where(ql < 1, Lq * Lr + Lr - 1 if Lq > 0 else 0, b)
    g = (H * Lr + (Lr - ql[:, None, None] - COL)).reshape(N, -1).max(1)
    g = np.where((ql >= 1) & (ql <= Lq), np.maximum(g, 0), 0)
    M = (Lq + 1) * Lr
    rem = b % M
    return (b // M, Lq - rem // Lr + 1, Lr - 1 - rem % Lr + 1, g // Lr,
            Lr - 1 - g % Lr + 1)


def _score_kernel_model(q, ql, r, params, census=None):
    p_match, p_mis, p_open, p_ext = params
    N, Lq = q.shape
    Lr = r.shape[1]
    lut, win, tab_a, tab_b = _stage(q, r, params)
    c = COL
    H = np.zeros((N, 32, 4), np.int64)
    V = np.full((N, 32, 4), NEG, np.int64)
    bk = np.zeros((N, 32, 4), np.int64)
    K = (Lq + 1) * Lr
    rows = np.minimum(ql, Lq)
    tie = {"best": np.full(N, -1), "split": np.zeros(N, bool)}
    for i in range(int(rows.max(initial=0))):
        act = (i < rows)[:, None, None]
        sub = _row_sub(lut, win, tab_a, tab_b, q, i, params)
        Vn = np.maximum(*_vertical(H, V, p_open, p_ext))
        Ht = np.maximum(np.maximum(H + sub, Vn), 0)
        x = Ht + p_ext * c
        pm = _del_window(x)
        F = pm - p_open - p_ext * c
        Hn = np.maximum(Ht, F)
        if census is not None:
            _census_row(census, x, F, Ht, Hn, act, tie)
        R = K - 1 - i * (Lr + 1)
        H = np.where(act, Hn, H)
        V = np.where(act, Vn, V)
        bk = np.where(act, np.maximum(bk, Hn * K + R), bk)
    if census is not None:
        census["qlen = 0"] += int((ql < 1).sum())
        census["qlen = Lq"] += int((ql == Lq).sum())
        census["best row's score in two threads"] += int(
            (tie["split"] & (tie["best"] > 0)).sum())
    # gbest once, from the last row, where that row is qlen - 1
    return _decode_keys(bk, H, ql, Lq, Lr)


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


# ------------------------------------------- the cigar kernel's row and walk
# A numpy model of ops/csrc/sw_banded.cu:sw_cigar_kernel: the score row
# with the 4-bit direction code a cell (cigar_row), in the same thread
# layout, then the warp-wide walk over the codes (diag_chain: 32 rows of a
# band column a round, ballots and popcounts) and the op buffer of two
# slots a lane, written back reversed by shuffles.  Keep it in step with
# the kernel.

def _sign(v):
    return (np.asarray(v) < 0).astype(np.int64)


def _cigar_rows(q, ql, r, params):
    """The row loop: (codes (N, Lq, 32) as the kernel stores them, bk,
    H), rows past min(qlen, Lq) left 0.  A thread's 16-bit code holds, for
    its column t, the move at bits 3t, 3t+1 and the I-extend bit at 3t+2
    (signs of sign words), and the D-extend bit at 12 + t."""
    p_match, p_mis, p_open, p_ext = params
    N, Lq = q.shape
    K, dR = (Lq + 1) * r.shape[1], r.shape[1] + 1
    lut, win, tab_a, tab_b = _stage(q, r, params)
    H = np.zeros((N, 32, 4), np.int64)
    V = np.full((N, 32, 4), NEG, np.int64)
    bk = np.zeros((N, 32, 4), np.int64)
    codes = np.zeros((N, Lq, 32), np.int64)
    rows = np.minimum(ql, Lq)
    for i in range(int(rows.max(initial=0))):
        act = (i < rows)[:, None, None]
        sub = _row_sub(lut, win, tab_a, tab_b, q, i, params)
        a, b = _vertical(H, V, p_open, p_ext)
        iext = b - a - 1                    # Hv - Vv - o - 1 < 0: I-extend
        Vn = np.maximum(a, b)
        diag = H + sub
        Ht = np.maximum(np.maximum(diag, Vn), 0)
        pm = _del_window(Ht + p_ext * COL, fill=-(1 << 30))
        left = _up(pm[..., 3], 1)[..., None]           # lane l-1's pm[3]
        dext = pm == np.concatenate([left, pm[..., :3]], -1)
        dext &= COL > 0
        Hn = np.maximum(Ht, pm - p_open - p_ext * COL)
        X, Y, Z = diag - Hn, Vn - Hn, -Hn
        b1, b0 = _sign(Z & X), _sign(Z & (Y | ~X))
        t3 = 3 * np.arange(4)
        code = ((b0 << t3) | (b1 << t3 + 1) | (_sign(iext) << t3 + 2)
                | (dext.astype(np.int64) << 12 + np.arange(4))).sum(-1)
        codes[:, i] = np.where(act[..., 0], code, 0)
        H = np.where(act, Hn, H)
        V = np.where(act, Vn, V)
        bk = np.where(act, np.maximum(bk, Hn * K + K - 1 - i * dR), bk)
    return codes, bk, H


def _ballot(pred):
    return sum(1 << k for k in range(32) if pred[k])


def _diag_chain(code_col, qcls, rcls, i, census):
    """The chain of diagonal moves ending at row i of one band column
    (code_col (Lq,), rcls already shifted by the column), 32 rows a
    round: (jump, NM's increase: the mismatches of the jumped rows)."""
    chain = mis = near = 0                       # near: in the first 127 rows
    far = []                                     # mismatches past row 127
    top = i
    while True:
        row = top - np.arange(32)
        ok = row >= 0
        rr = np.where(ok, row, 0)
        on = ok & ((code_col[rr] & 3) == 1)
        mm = (qcls[rr] == 4) | (qcls[rr] != rcls[rr])
        stop = _ballot(~on)
        k = (stop & -stop).bit_length() - 1 if stop else 32
        mb = _ballot(on & mm) & ((1 << k) - 1)
        room = 127 - chain
        far += [bool(mb >> t & 1) for t in range(k) if chain + t >= 127]
        mis += bin(mb).count("1")
        near += bin(mb & ((1 << max(min(room, 32), 0)) - 1)).count("1")
        chain += k
        if stop:
            break
        top -= 32
    census["chain of more than 32 rows"] += chain > 32
    census["jump capped at 127"] += chain > 127
    census["mismatch more than 127 rows up a chain"] += any(far)
    return min(chain, 127), min(mis, 127) - min(mis - near, 127)


def _cigar_kernel_model(q, ql, r, params, max_ops=48, census=None):
    census = collections.Counter() if census is None else census
    N, Lq = q.shape
    Lr = r.shape[1]
    codes, bk, H = _cigar_rows(q, ql, r, params)
    score, qend, rend, gscore, grend = _decode_keys(bk, H, ql, Lq, Lr)
    _, win, _, _ = _stage(q, r, params)
    rcls = win & 15
    qcls = np.where((q >= 0) & (q < 4), q, 4)
    t = np.arange(4)                               # nibbles: d | ve << 2 | de << 3
    codes = ((codes[..., None] >> 3 * t & 7) | (codes[..., None] >> 9 + t & 8)
             ).reshape(N, Lq, 128)                 # column c = 4l + t
    qbeg, rbeg = qend.copy(), rend.copy()
    nm = np.zeros(N, np.int64)
    n_ops = np.zeros(N, np.int64)
    ops = np.zeros((N, max_ops), np.int64)
    lens = np.zeros((N, max_ops), np.int64)
    for n in range(N):
        if ql[n] < 1:
            continue
        i, j, mode, kop, cur_op, cur_len = qend[n] - 1, rend[n] - 1, 0, 0, -1, 0
        slot0, slot1 = [0] * 32, [0] * 32
        for _ in range(Lq + Lr):
            c = j - i
            p = codes[n, min(max(i, 0), Lq - 1), min(max(c, 0), 127)]
            oob = i < 0 or j < 0 or c < 0 or c >= 128
            census["forced I step"] += mode == 1
            census["forced D step"] += mode == 2
            de = 2 if mode == 1 else 3 if mode == 2 else 0 if oob else p & 3
            op = {1: 0, 2: 1}.get(de, 2)
            step, nm_add = 1, 1
            if de == 1:
                step, nm_add = _diag_chain(codes[n, :, c], qcls[n],
                                           rcls[n, c:c + Lq], i, census)
            change = de != 0 and cur_len > 0 and op != cur_op
            if change or (de == 0 and cur_len > 0):
                kf = min(kop, max_ops - 1)
                (slot0 if kf < 32 else slot1)[kf & 31] = cur_op | cur_len << 2
                kop += 1
            if de == 0:
                break
            cur_len = step if change else cur_len + step
            cur_op = op
            nm[n] += nm_add
            i, j = {1: (i - step, j - step), 2: (i - 1, j)}.get(de, (i, j - 1))
            mode = 1 if de == 2 and p & 4 else 2 if de == 3 and p & 8 else 0
        census["op overflow"] += kop > max_ops
        nops = min(kop, max_ops)
        for lane in range(32):                   # the shuffles' write-back
            s0, s1 = nops - 1 - lane, nops - 33 - lane
            v0 = 0 if s0 < 0 else (slot0 if s0 < 32 else slot1)[s0 & 31]
            v1 = 0 if s1 < 0 else slot0[s1 & 31]
            for t, v in ((lane, v0), (lane + 32, v1)):
                if t < max_ops:
                    ops[n, t], lens[n, t] = v & 3, v >> 2
        n_ops[n], qbeg[n], rbeg[n] = nops, i + 1, j + 1
    qbeg = np.where(ql < 1, 1, qbeg)
    rbeg = np.where(ql < 1, 1, rbeg)
    return (score, qbeg, qend, rbeg, rend, gscore, grend, ops, lens, n_ops,
            nm), codes


@pytest.mark.parametrize("inputs", ["edge", "long"])
def test_cigar_kernel_model(case_set, inputs):
    """The traceback kernel's row (4-bit codes) and its warp-wide walk,
    modelled in its thread layout, are bit-equal to the twin in all 11
    outputs and to the Pallas kernel (interpret mode; ops and lens below
    n_ops) in all but NM, which _check_nm holds; its codes are the twin's
    direction words' low 4 bits, and the inputs run each branch of the
    walk (on the long chains, NM differs from the reference's)."""
    c = case_set
    q, ql, r, want = ((c["q"], c["ql"], c["r"], c["ref_cigar"])
                      if inputs == "edge" else
                      (*c["long"], c["long_cigar"]))
    census = collections.Counter()
    got, codes = _cigar_kernel_model(
        q.astype(np.int64), ql.astype(np.int64), r.astype(np.int64),
        c["params"], census=census)
    tq, tql, tr = (torch.from_numpy(a) for a in (q, ql, r))
    twin = sw_banded.sw_cigar_plain(tq, tql, tr, c["params"])
    below = np.arange(48)[None, :] < want[CIGAR_OUT.index("n_ops")][:, None]
    for name, a, w, t in zip(CIGAR_OUT, got, want, twin):
        assert np.array_equal(a, t.numpy()), name
        if name in ("ops", "lens"):
            a, w = np.where(below, a, 0), np.where(below, w, 0)
        if name != "nm":
            assert np.array_equal(a, w), name
    fixed = _check_nm(got[-1], want, q, r)
    assert inputs == "edge" or len(fixed) > 0
    dirs = sw_banded._dp(tq, tql, tr, c["params"], with_dirs=True)[2].numpy()
    live = (np.arange(q.shape[1])[None, :] < np.minimum(ql, q.shape[1])[
        :, None])[..., None]
    assert np.array_equal(np.where(live, codes, 0),
                          np.where(live, dirs & 15, 0))
    need = {"edge": ["forced I step", "forced D step",
                     "chain of more than 32 rows"],
            "long": ["jump capped at 127", "chain of more than 32 rows",
                     "mismatch more than 127 rows up a chain"]}[inputs]
    if inputs == "edge" and c["params"] == (1, 4, 1, 1):
        need.append("op overflow")
    assert all(census[k] > 0 for k in need), dict(census)


def _edit_distance(q, r, qbeg, rbeg, ops, lens, n_ops):
    """NM recounted from a cigar: mismatches over its M ops (a base
    outside A, C, G, T on either side counts as one), plus the bases of
    its I and D ops."""
    qi, rj, nm = int(qbeg), int(rbeg), 0
    for op, ln in zip(ops[:n_ops], lens[:n_ops]):
        if op == 0:
            a, b = q[qi:qi + ln], r[rj:rj + ln]
            odd = (a < 0) | (a > 3) | (b < 0) | (b > 3)
            nm += int(((a != b) | odd).sum())
            qi, rj = qi + ln, rj + ln
        else:
            nm += int(ln)
            qi, rj = (qi + ln, rj) if op == 1 else (qi, rj + ln)
    return nm


def test_nm_counts_long_runs_as_the_reference_does():
    """The reference's NM double count, repaired (ROADMAP, deliberate
    differences): a diagonal run longer than 127 rows is jumped 127 rows
    at a time, and the Pallas kernel adds at each jump the mismatches of
    the whole run ending where it starts, so a mismatch in the first
    len - 127 rows of an ungapped 150-row alignment counts twice: NM 2 for
    a 150 bp read equal to its window but at query row 5, where the cigar
    (150M) has edit distance 1.  The twin adds the mismatches of the rows
    each jump covers: NM 1 at rows 5, 60 and 140 (the kernel's numpy model
    and the card's kernel agree with the twin)."""
    rng = np.random.default_rng(150)
    q = np.full((64, 151), 4, np.int32)
    r = rng.integers(0, 4, (64, 256)).astype(np.int32)
    ql = np.full(64, 150, np.int32)
    at = np.array([5, 60, 140])[np.arange(64) % 3]
    for n in range(64):
        off = int(rng.integers(0, 100))
        q[n, :150] = r[n, off:off + 150]
        q[n, at[n]] = (q[n, at[n]] + 1) % 4
    twin = [t.numpy() for t in sw_banded.sw_cigar_plain(
        *(torch.from_numpy(a) for a in (q, ql, r)))]
    pallas = [np.asarray(a) for a in sw_pallas_cigar(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), params=(1, 4, 6, 1),
        interpret=True)]
    model, _ = _cigar_kernel_model(q.astype(np.int64), ql.astype(np.int64),
                                   r.astype(np.int64), (1, 4, 6, 1))
    for out, want in ((twin, np.ones(64)), (model, np.ones(64)),
                      (pallas, np.where(at == 5, 2, 1))):
        score, qbeg, qend, rbeg, rend, _, _, ops, lens, n_ops, nm = out
        assert (n_ops == 1).all() and (ops[:, 0] == 0).all()
        assert (lens[:, 0] == 150).all() and (score == 145).all()
        assert np.array_equal(nm, want)
        assert all(_edit_distance(q[n], r[n], qbeg[n], rbeg[n], ops[n],
                                  lens[n], n_ops[n]) == 1 for n in range(64))
