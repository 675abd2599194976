"""ops/seed_chain.py on the CPU: the wrapper is the plain composition
find_seeds_hash -> chain_seeds_nms (which tests/test_torch_index.py holds
to the JAX package), and ``_kernel_model``, a numpy model of
csrc/seed_chain.cu (lanes and their ballot ranks, the compaction in slot
order, strand ranges, the rounds with the lowest member as anchor, the
empty rounds), is bit-equal to that composition, and each of its
MUTATIONS breaks it.  Keep the model in step with the kernel when it
changes."""

import numpy as np
import pytest
import torch

from speedseq_tpu_torch.align.chain import Chains, chain_seeds_nms
from speedseq_tpu_torch.index import kmer
from speedseq_tpu_torch.ops import seed_chain as sc
from speedseq_tpu_torch.utils import seed_chain_cases as cases

BIGQ = 1 << 20
M32 = 0xFFFFFFFF


def _i32(x):
    return ((np.asarray(x, np.int64) + 2**31) & M32) - 2**31


@pytest.fixture(scope="module")
def worlds():
    """KmerIndex of a random and of a repeat-rich genome, per k."""
    out = {}
    for kind in ("random", "repeats"):
        g = cases.genome(kind, 120_000, seed=7)
        for k in (17, 19, 24):
            out[kind, k] = (g, kmer.build_kmer_index(g, k=k))
    return out


def _twin(kidx, reads, lengths, k, stride, H, K):
    seeds = kmer.find_seeds_hash(kidx, reads, lengths, k=k, stride=stride,
                                 max_hits=H)
    ch = chain_seeds_nms(seeds, reads.shape[1], k=K)
    diag = ch.anchor_rpos - ch.anchor_qpos
    return ch, diag + ch.qspan_beg, diag + ch.qspan_end


def _assert_same(got, want):
    (gc, gp, gr), (wc, wp, wr) = got, want
    for name in Chains._fields:
        a, b = getattr(gc, name), getattr(wc, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(gp, wp) and torch.equal(gr, wr)


@pytest.mark.parametrize("kind,k,stride,K,B,L", [
    ("random", 19, 8, 4, 40, 151), ("repeats", 19, 8, 4, 40, 151),
    ("repeats", 17, 8, 2, 33, 151), ("random", 24, 8, 8, 17, 151),
    ("repeats", 19, 1, 4, 6, 151), ("random", 17, 5, 8, 9, 101),
    ("repeats", 24, 3, 2, 5, 40), ("random", 19, 8, 4, 3, 19)])
def test_wrapper_on_cpu_is_the_composition(worlds, kind, k, stride, K, B,
                                           L):
    """Both ends through one call on CPU tensors: each equals the twin
    composition on its own end (the second end one base narrower)."""
    g, kidx = worlds[kind, k]
    r1, l1 = cases.reads(g, B, L, seed=B)
    r2, l2 = cases.reads(g, B + 1, max(L - 1, k), seed=B + 1)
    ends = [(torch.from_numpy(r), torch.from_numpy(ln))
            for r, ln in ((r1, l1), (r2, l2))]
    got = sc.seed_chain(kidx, ends, k=k, stride=stride, max_hits=4,
                        n_chains=K)
    assert len(got) == 2
    for (r, ln), res in zip(ends, got):
        _assert_same(res, _twin(kidx, r, ln, k, stride, 4, K))
        assert res[0].valid.shape == (r.shape[0], K)


def test_wrapper_refuses_what_the_twin_cannot_take(worlds):
    g, kidx = worlds["random", 19]
    r, ln = (torch.from_numpy(a) for a in cases.reads(g, 4, 151))
    bad = [dict(k=16), dict(k=25), dict(max_hits=9), dict(max_hits=0),
           dict(n_chains=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            sc.seed_chain(kidx, [(r, ln)], **kw)
    with pytest.raises(ValueError, match="read width"):
        sc.seed_chain(kidx, [(r[:, :18], ln)])
    with pytest.raises(ValueError):
        sc.seed_chain(kidx, [(r, ln[:3])])
    with pytest.raises(ValueError):
        sc.seed_chain(kidx, [(r, ln)] * 3)


MUTATIONS = ("anchor-is-the-last-member", "ties-to-the-higher-slot",
             "rank-by-column", "no-max-occ", "empty-round-reverse-strand")


def _kernel_model(kidx, reads, lengths, k, stride, H, K, max_scan=8,
                  max_occ=500, band=100, mutation=None):
    """numpy model of csrc/seed_chain.cu for one end: (9, B, K) int64
    fields (ops/seed_chain.py:FIELDS) and (B, K) valid.  ``mutation`` (one
    of MUTATIONS) breaks one rule on purpose."""
    mut = lambda name: mutation == name
    bs = kidx.bucket_start.numpy().astype(np.int64)
    positions = kidx.positions.numpy().astype(np.int64)
    fp = kidx.fp.numpy().astype(np.int64)
    n_entries, shift = len(positions), 32 - kidx.bits
    B, L = reads.shape
    G = sc.n_anchors(L, k, stride)
    GH, S, maxa = G * H, 2 * G * H, max(L - k, 0)
    P = 1 << (max_scan - 1).bit_length()
    mul = lambda a, c: (a * int(c)) & M32
    out = np.zeros((9, B, K), np.int64)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        rd = reads[b].astype(np.int64)
        ln = int(lengths[b])
        fwd = np.clip(rd, 0, 4)
        idx = ln - 1 - np.arange(L)
        v = rd[np.clip(idx, 0, L - 1)]
        rc = np.clip(np.where(idx >= 0, np.where(v < 4, 3 - v, v), 4), 0, 4)
        st_rpos = np.zeros(S, np.int64)
        st_ok = np.zeros(S, bool)
        for grp in range(2 * G):             # one group of P lanes each
            s, g = int(grp >= G), grp % G
            a = min(g * stride, maxa)
            win = (rc if s else fwd)[a:a + k]
            oks, poss = np.zeros(P, bool), np.full(P, -1, np.int64)
            if not (win > 3).any() and a + k <= ln:
                lo = hi = 0
                for q, c in enumerate(win):
                    if q < k - 16:
                        hi = (hi << 2) | int(c)
                    else:
                        lo = ((lo << 2) | int(c)) & M32
                h = mul(lo, kmer.MULT_LO) ^ mul(hi, kmer.MULT_HI)
                f = mul(lo, kmer.FP_LO) ^ mul(hi, kmer.FP_HI)
                bkt = 0 if shift >= 32 else h >> shift
                st, nin = bs[bkt], bs[bkt + 1] - bs[bkt]
                for j in range(P):
                    if ((nin <= max_occ or mut("no-max-occ")) and j < nin
                            and j < max_scan):
                        ci = min(max(st + j, 0), n_entries - 1)
                        poss[j], oks[j] = positions[ci], fp[ci] == f >> 16
            gm = sum(1 << j for j in range(P) if oks[j])   # the ballot
            slot0 = s * GH + g * H
            for j in range(P):
                rank = (j if mut("rank-by-column")
                        else bin(gm & ((1 << j) - 1)).count("1"))
                if oks[j] and rank < H:
                    st_rpos[slot0 + rank], st_ok[slot0 + rank] = poss[j], 1
                if j < H and j >= bin(gm).count("1"):
                    st_rpos[slot0 + j], st_ok[slot0 + j] = -1, 0
        c_slot = np.nonzero(st_ok)[0]                 # compaction
        c_rpos = st_rpos[c_slot]
        c_qpos = np.minimum((c_slot % GH) // H * stride, maxa)
        c_diag = _i32(c_rpos - c_qpos + L)
        n_v, n_f = len(c_slot), int((c_slot < GH).sum())
        act = np.ones(n_v, bool)
        for r in range(K):
            bk, bi, stats = -1, None, {}
            for i in np.nonzero(act)[0]:
                lo_j, hi_j = (0, n_f) if i < n_f else (n_f, n_v)
                j = np.arange(lo_j, hi_j)
                d = _i32(c_diag[i] - c_diag[j])
                mem = j[act[j] & (np.where(d < 0, _i32(-d), d) <= band)]
                mn, mx = c_qpos[mem].min(), c_qpos[mem].max() + k
                w = min(mx - mn, k * len(mem))
                key = int(_i32(w * 1024 + (
                    c_slot[i] if mut("ties-to-the-higher-slot")
                    else S - 1 - c_slot[i])))
                stats[i] = (mn, mx, mem[0], w, mem)
                if key > bk:
                    bk, bi = key, i
            if bk < 0:
                for rr in range(r, K):
                    out[:, b, rr] = (-1, 0, k,
                                     int(mut("empty-round-reverse-strand")),
                                     0, BIGQ - 1, 0, BIGQ - 2, -1)
                break
            mn, mx, a, w, mem = stats[bi]
            a = mem[-1] if mut("anchor-is-the-last-member") else a
            ar, aq, qb = c_rpos[a], c_qpos[a], min(mn, BIGQ - 1)
            out[:, b, r] = (ar, aq, k, int(c_slot[a] >= GH), w, qb, mx,
                            _i32(ar - aq + qb), _i32(ar - aq + mx))
            valid[b, r] = True
            act[mem] = False
    return out, valid


@pytest.mark.parametrize("kind,k,stride,H,K,B,L", [
    ("random", 19, 8, 4, 4, 24, 151), ("repeats", 19, 8, 4, 4, 48, 151),
    ("repeats", 17, 8, 2, 8, 24, 151), ("repeats", 24, 8, 8, 2, 16, 151),
    ("random", 24, 1, 4, 8, 4, 151), ("repeats", 19, 1, 4, 4, 4, 151),
    ("repeats", 17, 6, 1, 4, 12, 60), ("random", 19, 8, 3, 4, 6, 19)])
def test_kernel_model_matches_twin(worlds, kind, k, stride, H, K, B, L):
    """The kernel's algorithm in numpy against the twin, at k 17/19/24,
    stride 1 (S = 1,064 at k 19: above the key's 2^10 slots) to 8,
    max_hits 1 to 8 (7 lanes idle at 1), reads of every awkward kind, and
    empty rounds."""
    g, kidx = worlds[kind, k]
    r, ln = cases.reads(g, B, L, seed=3 * B + k)
    ch, pos, rend = _twin(kidx, torch.from_numpy(r), torch.from_numpy(ln),
                          k, stride, H, K)
    out, valid = _kernel_model(kidx, r, ln, k, stride, H, K)
    want = [getattr(ch, f) for f in sc.FIELDS[:7]] + [pos, rend]
    for name, a, w in zip(sc.FIELDS, out, want):
        assert np.array_equal(a, w.numpy()), name
    assert np.array_equal(valid, ch.valid.numpy())
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_kernel_model_mutations_break_it(worlds, mutation):
    """Each of MUTATIONS makes the model disagree with the twin on 64 reads
    of the repeat-rich genome (STR buckets past max_occ, buckets holding
    other k-mers ahead of a verified one, groups of several seeds)."""
    g, kidx = worlds["repeats", 19]
    r, ln = cases.reads(g, 64, 151, seed=64)
    ch, pos, rend = _twin(kidx, torch.from_numpy(r), torch.from_numpy(ln),
                          19, 8, 4, 4)
    out, valid = _kernel_model(kidx, r, ln, 19, 8, 4, 4, mutation=mutation)
    want = [getattr(ch, f) for f in sc.FIELDS[:7]] + [pos, rend]
    assert (not np.array_equal(valid, ch.valid.numpy())
            or any(not np.array_equal(a, w.numpy())
                   for a, w in zip(out, want))), mutation
