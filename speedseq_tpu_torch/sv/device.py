"""Device programs of sv, in torch on the run's device: LUMPY clustering
and curve combination, SVTyper counting and genotyping, and CNVnator depth
binning, GC correction and mean-shift partition.

Ported from the JAX package's ``sv/device.py``.  The cluster sweep, a
serial scan with one step per evidence row, is the hand CUDA kernel of
``ops/sv_cluster.py``, and each cluster's sum of member log curves is
the hand kernel of ``ops/sv_combine.py``; everything else is tensor
code.  Where float32 summation order would decide an integer (a curve's
argmax, a CI, a segment boundary), the sum is taken in a fixed order or
in float64, so the card and the CPU agree:

- each cluster's log-product is summed over its member rows in row order
  (the kernel's serial loop, the twin's loop over member rank), the order
  of the reference's float32 ``segment_sum`` on the CPU;
- curve normalisers, the 95 % mass cumsum and the mean-shift gradient are
  taken in float64 (the gradient as an antisymmetric pair sum, exactly 0
  on a flat profile);
- the mean-shift segment sums are int64 sums of fixed-point values, the
  same bits in any order on either device;
- counts are integer sums (GC correction's are integer-valued float64,
  exact in any order).

Host code (BAM/VCF bytes, SA-tag parsing, call assembly) stays in numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sv_cluster, sv_combine
from ..utils.metrics import metrics

# svtype codes inside the SVTyper program
SV_DEL, SV_DUP, SV_INV, SV_BND = 0, 1, 2, 3

# rows of a (rows, 2h+1) mean-shift window held at a time
MEAN_SHIFT_CHUNK = 8192


def _pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a float32 matrix, taken in float64 (order-free to far
    below float32's precision) and rounded to float32."""
    return x.double().sum(dim=1, keepdim=True).float()


# ---------------------------------------------------------------------------
# cluster sweep + curve combination (lumpy -P -r, sv/cluster.py semantics)
# ---------------------------------------------------------------------------

class CombinedClusters(NamedTuple):
    """Host-side results of the cluster + combine pass."""

    cids: np.ndarray        # (n,) cluster id per (sorted) evidence row
    n_clusters: int
    # per-cluster, for both breakpoint sides (index 0 = side1, 1 = side2)
    prob: Tuple[np.ndarray, np.ndarray]    # (C, W) rows
    pos: Tuple[np.ndarray, np.ndarray]
    ci: Tuple[np.ndarray, np.ndarray]      # (C, 2)
    ci95: Tuple[np.ndarray, np.ndarray]
    nz: Tuple[np.ndarray, np.ndarray]      # (C, 2) live curve window


def _combine(lo, hi, start, clen, curves, first, sizes, trim, W: int):
    """Per-cluster log-product of member curves over the union support,
    then pos / CI / CI95 (the JAX package's ``_combine_jit``).  Returns
    (prob (C, W) float32, ints (C, 7) int32 = pos, CI, CI95, nz)."""
    dev = lo.device
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    # each cluster's member log curves summed in row order: one launch of
    # the hand kernel on cuda, the member-rank loop on the CPU
    acc = sv_combine.combine_logsum(first, sizes, lo, start, clen, curves, W)
    width = torch.clamp_min(hi - lo, 1)
    live_col = col < width[:, None]
    acc = torch.where(live_col, acc, -torch.inf)
    acc = acc - acc.max(dim=1, keepdim=True).values
    prob = torch.where(live_col, torch.exp(acc), 0.0)
    prob = prob / torch.clamp_min(_rowsum(prob), 1e-30)

    # lumpy -r trim: drop edges below the threshold, renormalise (trim = 0
    # keeps every column and only renormalises)
    livemask = prob >= trim
    has = livemask.any(dim=1)
    first_c = torch.where(livemask, col, W).amin(dim=1)
    last_c = torch.where(livemask, col, -1).amax(dim=1)
    keepm = (col >= first_c[:, None]) & (col <= last_c[:, None])
    tprob = torch.where(keepm, prob, 0.0)
    tprob = tprob / torch.clamp_min(_rowsum(tprob), 1e-30)
    prob = torch.where(has[:, None], tprob, prob)

    pos = lo + torch.argmax(prob, dim=1).to(torch.int32)
    nzmask = prob > 1e-9
    nz0 = torch.where(nzmask, col, W).amin(dim=1)
    nz1 = torch.where(nzmask, col, -1).amax(dim=1)
    # 95 % credible interval: mass-ordered threshold (ties at the boundary
    # all kept, as the reference does)
    sp = torch.sort(prob, dim=1, descending=True).values
    csum = torch.cumsum(sp.double(), dim=1)
    k95 = (csum < 0.95).sum(dim=1).clamp_max(W - 1)
    thr = torch.gather(sp, 1, k95[:, None])
    keep95 = prob >= thr
    c0 = torch.where(keep95, col, W).amin(dim=1)
    c1 = torch.where(keep95, col, -1).amax(dim=1)
    ints = torch.stack([pos, lo + nz0 - pos, lo + nz1 - pos,
                        lo + c0 - pos, lo + c1 - pos, nz0, nz1], dim=1)
    return prob, ints.to(torch.int32)


def cluster_and_combine(
    gid: np.ndarray,
    start1: np.ndarray, len1: np.ndarray, curves1: np.ndarray,
    start2: np.ndarray, len2: np.ndarray, curves2: np.ndarray,
    trim: float, device=None,
) -> CombinedClusters:
    """The cluster sweep and both sides' curve combinations on the run's
    device.  Inputs are evidence rows ALREADY sorted by (gid, start1,
    start2); curves are (n, Dmax) padded probability rows."""
    dev = resolve_device(device)
    metrics.add(f"sv.cluster_scans.{dev.type}")
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    g, s1, l1, s2, l2 = (i32(a) for a in (gid, start1, len1, start2, len2))
    e1, e2 = s1 + l1, s2 + l2
    with metrics.timer("sv.cluster_sweep"):
        cids = sv_cluster.cluster_scan(g, s1, e1, s2, e2)
        C = int(cids[-1]) + 1
        lo1, hi1 = sv_cluster.cluster_extents(cids, s1, e1, C)
        lo2, hi2 = sv_cluster.cluster_extents(cids, s2, e2, C)
        sizes = torch.bincount(cids.long(), minlength=C)
        head = torch.stack([(hi1 - lo1).max(), (hi2 - lo2).max()])
        head_h = head.cpu().numpy()
    with metrics.timer("sv.cluster_combine"):
        W = _pow2(int(max(head_h.max(), 8)), 16)
        first = torch.cumsum(sizes, 0) - sizes
        sides = []
        for lo, hi, s, ln, cur in ((lo1, hi1, s1, l1, curves1),
                                   (lo2, hi2, s2, l2, curves2)):
            cur_t = torch.as_tensor(np.asarray(cur, np.float32), device=dev)
            prob, ints = _combine(lo, hi, s, ln, cur_t, first, sizes, trim,
                                  W)
            sides.append((prob.cpu().numpy(), ints.cpu().numpy()))
        cids_h = cids.cpu().numpy()
    (p1, i1), (p2, i2) = sides
    return CombinedClusters(
        cids=cids_h, n_clusters=C,
        prob=(p1, p2), pos=(i1[:, 0], i2[:, 0]),
        ci=(i1[:, 1:3], i2[:, 1:3]), ci95=(i1[:, 3:5], i2[:, 3:5]),
        nz=(i1[:, 5:7], i2[:, 5:7]),
    )


# ---------------------------------------------------------------------------
# SVTyper: window counting + count→GL genotyping over all calls
# ---------------------------------------------------------------------------

def genotype_counts(ref_n: torch.Tensor, alt_n: torch.Tensor,
                    p_err: float = 1e-3):
    """Vectorised genotype_from_counts (svtyper.py) in float32: same
    rounding and the same tie rule (an argmax over the reversed genotype
    axis prefers the later genotype).  Returns (gl (C, 3), gt, gq, sq,
    ab)."""
    dev = ref_n.device
    ref = ref_n.to(torch.float32)
    alt = alt_n.to(torch.float32)
    nn = ref + alt
    lc = torch.lgamma(nn + 1) - torch.lgamma(alt + 1) - torch.lgamma(ref + 1)
    l10 = torch.tensor(np.log(10.0), dtype=torch.float32, device=dev)
    pa = torch.tensor([p_err, 0.5, 1.0 - p_err], dtype=torch.float32,
                      device=dev)
    ll = (lc[:, None]
          + alt[:, None] * torch.log(torch.clamp_min(pa, 1e-12))[None, :]
          + ref[:, None] * torch.log(torch.clamp_min(1.0 - pa, 1e-12))[None, :]
          ) / l10                                              # (C, 3)
    best = 2 - torch.argmax(ll.flip(-1), dim=-1)
    g3 = torch.arange(3, device=dev)[None, :]
    masked = torch.where(g3 == best[:, None], -torch.inf, ll)
    second = 2 - torch.argmax(masked.flip(-1), dim=-1)
    gbest = torch.gather(ll, 1, best[:, None])[:, 0]
    gsec = torch.gather(ll, 1, second[:, None])[:, 0]
    gq = torch.clamp_max(torch.round(10.0 * (gbest - gsec)), 99)
    # stable log-space posterior of 0/0 (the host's log form)
    m = ll.max(dim=-1, keepdim=True).values
    post = torch.pow(10.0, ll - m)
    log10_p0 = (ll[:, 0] - m[:, 0]) - torch.log10(post.sum(dim=-1))
    sq = torch.clamp_max(-10.0 * torch.clamp_min(log10_p0, -20.0), 200.0)
    ab = torch.where(nn > 0, alt / torch.clamp_min(nn, 1), 0.0)
    return ll, best.to(torch.int32), gq.to(torch.int32), sq, ab


def svtyper_program(a, b, R: int, rec: Sequence[torch.Tensor], call_cols,
                    scalars, device=None, mesh=None):
    """Counts and GL for a batch of calls of one sample (the JAX package's
    ``_svtyper_kernel``).

    a, b: (C, 2) numpy [a, b) record ranges of each (call, breakpoint)
    window in the sorted record columns; R >= max(b - a) the gather width;
    rec: 14 (n,) device tensors (pos, end, tid, mtid, mpos, mend, base, cl,
    cr, sa, rev1, rev2, proper, mateok); call_cols: 7 (C,) numpy columns
    (svcode, tid1, pos1, tid2, pos2, strand1, strand2); scalars: (slop, w,
    wiggle, max_normal).  Returns device tensors (ref_n, alt_n, rs, as, rp,
    ap, gl, gt, gq, sq, ab), not yet fetched.

    ``mesh`` (a parallel.mesh.Mesh; ``device`` is then unused) shards the
    call axis: calls are padded to a multiple of 8 x the mesh size (a pad
    call has empty windows), the record columns go to every device, and
    the outputs are concatenated in shard order on the mesh's first
    device.  Calls are independent, so the output is the unsharded one."""
    if mesh is None:
        return _svtyper_one(a, b, R, rec, call_cols, scalars,
                            resolve_device(device))
    C, n = len(a), mesh.size
    step = 8 * n
    Cp = max(step, -(-C // step) * step)
    pad = lambda x: np.concatenate(
        [np.asarray(x), np.zeros((Cp - C,) + np.shape(x)[1:],
                                 np.asarray(x).dtype)])
    a_p, b_p = pad(a), pad(b)
    calls_p = [pad(c) for c in call_cols]
    per = Cp // n

    def shard(s, dev):
        sl = slice(s * per, (s + 1) * per)
        return _svtyper_one(a_p[sl], b_p[sl], R, [t.to(dev) for t in rec],
                            [c[sl] for c in calls_p], scalars, dev)

    outs = mesh.map(shard)
    dev0 = mesh.devices[0]
    return tuple(torch.cat([o[k].to(dev0) for o in outs])[:C]
                 for k in range(len(outs[0])))


def _svtyper_one(a, b, R: int, rec, call_cols, scalars, dev: torch.device):
    """svtyper_program on one device."""
    metrics.add(f"sv.svtyper_programs.{dev.type}")
    slop, w, wiggle, max_normal = (int(s) for s in scalars)
    n = rec[0].shape[0]
    if n == 0:       # no records: every window is empty, gather a dummy row
        rec = [torch.zeros(1, dtype=t.dtype, device=dev) for t in rec]
    a_t = torch.as_tensor(np.asarray(a, np.int64), device=dev)
    b_t = torch.as_tensor(np.asarray(b, np.int64), device=dev)
    idx = a_t[:, :, None] + torch.arange(R, device=dev)[None, None, :]
    valid = idx < b_t[:, :, None]
    idx = idx.clamp(0, max(n - 1, 0))
    (posg, endg, tidg, mtidg, mposg, mendg, baseg, clg, crg, sag, rev1g,
     rev2g, properg, mateokg) = (t[idx] for t in rec)      # (C, 2, R)
    svcode, tid1, pos1, tid2, pos2, strand1, strand2 = (
        torch.as_tensor(np.asarray(c, np.int32), device=dev)
        for c in call_cols)

    pos_cs = torch.stack([pos1, pos2], dim=1)[:, :, None]     # (C, 2, 1)
    tid_cs = torch.stack([tid1, tid2], dim=1)[:, :, None]
    base = (valid & baseg & (tidg == tid_cs)
            & (endg > pos_cs - w) & (posg < pos_cs + w))
    at_end = (endg - pos_cs).abs() <= slop
    at_start = (posg - pos_cs).abs() <= slop
    split_alt = base & sag & ((at_end & crg) | (at_start & clg))
    crossing = (base & ~split_alt
                & (posg + slop <= pos_cs) & (pos_cs <= endg - slop)
                & ~clg & ~crg)

    # ---- pair evidence: breakpoint-1 rows only --------------------------
    b1 = lambda t: t[:, 0, :]
    posb, endb, tidb = b1(posg), b1(endg), b1(tidg)
    mtidb, mposb, mendb = b1(mtidg), b1(mposg), b1(mendg)
    rev1b, rev2b, properb = b1(rev1g), b1(rev2g), b1(properg)
    cand = (b1(base) & ~b1(split_alt) & ~b1(crossing) & b1(mateokg)
            & ((tidb < mtidb) | ((tidb == mtidb) & (posb <= mposb))))
    p1c = pos1[:, None]
    p2c = pos2[:, None]
    span = mendb - posb
    crosses1 = (posb < p1c) & (p1c < mendb)
    same1 = tidb == tid1[:, None]

    covers = ((endb - 1 <= p1c + wiggle) & (mposb >= p2c - wiggle)
              & (posb < p1c) & (mendb > p2c))
    del_alt = cand & ~rev1b & rev2b & same1 & covers & (span > max_normal)
    del_ref = (cand & ~del_alt & ~rev1b & rev2b & same1 & crosses1
               & (span <= max_normal) & properb)
    dnear1 = (posb - p1c).abs() < max_normal
    dnear2 = (mendb - p2c).abs() < max_normal
    dup_alt = cand & rev1b & ~rev2b & dnear1 & dnear2
    dup_ref = cand & ~dup_alt & crosses1 & ~rev1b & rev2b & properb
    inv_alt = cand & (rev1b == rev2b)
    inv_ref = cand & ~inv_alt & crosses1 & properb
    bnear1 = (posb - p1c).abs() < max_normal
    bnear2 = (mposb - p2c).abs() < max_normal
    orient = ((rev1b == (strand1[:, None] == 1))
              & (rev2b == (strand2[:, None] == 1)))
    bnd_alt = (cand & same1 & (mtidb == tid2[:, None]) & bnear1 & bnear2
               & orient)
    bnd_ref = cand & ~bnd_alt & crosses1 & properb

    sc = svcode[:, None]
    alt_pair = torch.where(sc == SV_DEL, del_alt, torch.where(
        sc == SV_DUP, dup_alt, torch.where(sc == SV_INV, inv_alt, bnd_alt)))
    ref_pair = torch.where(sc == SV_DEL, del_ref, torch.where(
        sc == SV_DUP, dup_ref, torch.where(sc == SV_INV, inv_ref, bnd_ref)))

    i32 = torch.int32
    as_c = split_alt.sum(dim=(1, 2), dtype=i32)
    rs_c = crossing.sum(dim=(1, 2), dtype=i32)
    ap_c = alt_pair.sum(dim=1, dtype=i32)
    rp_c = ref_pair.sum(dim=1, dtype=i32)
    alt_n = as_c + ap_c
    ref_n = rs_c + rp_c
    gl, gt, gq, sq, ab = genotype_counts(ref_n, alt_n)
    return ref_n, alt_n, rs_c, as_c, rp_c, ap_c, gl, gt, gq, sq, ab


# ---------------------------------------------------------------------------
# CNV: depth binning, GC correction, mean-shift partition
# ---------------------------------------------------------------------------

def depth_bins(bin_idx: np.ndarray, n_bins: int, device=None) -> np.ndarray:
    """Reads per global bin (int64, exact)."""
    dev = resolve_device(device)
    metrics.add(f"sv.depth_programs.{dev.type}")
    t = torch.as_tensor(np.asarray(bin_idx, np.int64), device=dev)
    return torch.bincount(t, minlength=n_bins)[:n_bins].cpu().numpy()


def gc_correct(counts: np.ndarray, strata: np.ndarray, valid: np.ndarray,
               device=None) -> Tuple[np.ndarray, float]:
    """Per-1%-GC-stratum correction (cnvnator model): stratum mean → factor
    mean / stratum_mean for strata with >= 20 bins.  The sums of integer
    counts are taken in float64, exact in any order up to 2**53, then
    rounded to float32; the JAX package sums in float32, which is exact
    only while the total read count stays below 2**24, so the two agree
    there and only the reference drifts above it."""
    dev = resolve_device(device)
    metrics.add(f"sv.depth_programs.{dev.type}")
    f32 = torch.float32
    c = torch.as_tensor(np.asarray(counts, np.float32), device=dev)
    st = torch.as_tensor(np.asarray(strata, np.int64), device=dev)
    usedf = torch.as_tensor(np.asarray(valid, bool), device=dev).to(f32)
    cu = c * usedf
    total = cu.double().sum().float()
    ncnt = usedf.double().sum().float()
    mean = total / torch.clamp_min(ncnt, 1.0)
    z = torch.zeros(101, dtype=torch.float64, device=dev)
    ssum = z.index_add(0, st, cu.double()).float()
    scnt = z.index_add(0, st, usedf.double()).float()
    smean = ssum / torch.clamp_min(scnt, 1.0)
    corr = torch.where((scnt >= 20) & (smean > 0),
                       mean / torch.clamp_min(smean, 1e-12),
                       torch.ones((), dtype=f32, device=dev))
    corrected = c * corr[st] * usedf
    return corrected.cpu().numpy(), float(mean)


def _mean_shift_step(x: torch.Tensor, mean: float, h: int,
                     frac: int) -> torch.Tensor:
    """One mean-shift pass at bandwidth h bins: the gradient of the kernel
    density in (position, signal) space, segment boundaries where
    attraction changes direction (i-1 pulled left, i pulled right), bins
    replaced by their segment means.  Signal bandwidth is depth-dependent
    (Poisson: var ≈ depth), CNVnator's model.  State in float32; the
    window math and the gradient in float64; the segment sums in int64 of
    the bins rounded to multiples of 2**-frac."""
    dev = x.device
    n = x.shape[0]
    xd = x.double()
    xp = torch.cat([xd[:1].expand(h), xd, xd[-1:].expand(h)])
    k = torch.arange(1, h + 1, dtype=torch.float64, device=dev)
    kw = k * torch.exp(-0.5 * (k / (h / 2.0)) ** 2)     # offset × position weight
    floor = float(mean) * 0.125
    grad = torch.empty(n, dtype=torch.float64, device=dev)
    for c0 in range(0, n, MEAN_SHIFT_CHUNK):
        c1 = min(n, c0 + MEAN_SHIFT_CHUNK)
        win = xp.unfold(0, 2 * h + 1, 1)[c0:c1]           # view (m, 2h+1)
        xc = xd[c0:c1, None]
        sig2 = ((xc + win) * 0.5).clamp_min_(floor)
        wgt = torch.exp(-0.5 * (win - xc) ** 2 / sig2)
        # sum_k k·w_k·(wgt[+k] − wgt[−k]): exactly 0 where the two sides agree
        grad[c0:c1] = ((wgt[:, h + 1:] - wgt[:, :h].flip(1)) * kw).sum(dim=1)
    gl = torch.cat([grad.new_zeros(1), grad[:-1]])
    brk = (gl < 0) & (grad > 0)
    brk[0] = False
    seg = torch.cumsum(brk.long(), 0)
    q = torch.round(xd * 2.0 ** frac).long()
    ssum = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, seg, q)
    scnt = torch.bincount(seg, minlength=n).clamp_min(1).double()
    return (ssum.double() * 2.0 ** -frac / scnt).float()[seg]


def mean_shift_partition(x: np.ndarray, mean: float, device=None,
                         scales=(2, 4, 8, 16, 32, 64, 128)) -> np.ndarray:
    """Multi-scale mean-shift partition of one chromosome's corrected depth
    profile; each scale iterates to a fixed point (at most 30 passes, until
    no bin moves by more than 1e-3 · mean)."""
    if len(x) == 0:
        return x
    dev = resolve_device(device)
    metrics.add(f"sv.depth_programs.{dev.type}")
    xv = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    m = np.float32(max(mean, 1e-9))
    tol = float(np.float32(1e-3) * m)
    # fixed point of the segment sums: no pass raises max|x| (a segment
    # mean lies within its bins), so every sum of |x| · 2**frac stays
    # under 2**62 (+ n/2 of rounding); the resolution, max|x| · n / 2**62,
    # is far below float32's at the segment means
    big = max(float(np.abs(np.asarray(x, np.float32)).max()) * len(x),
              2.0 ** -60)
    frac = 62 - math.ceil(math.log2(big))
    for h in scales:
        if 2 * h + 1 >= len(x):
            break
        prev, xv = xv, _mean_shift_step(xv, m, h, frac)
        it = 1
        while it < 30 and float((xv - prev).abs().max()) > tol:
            prev, xv = xv, _mean_shift_step(xv, m, h, frac)
            it += 1
    return xv.cpu().numpy().astype(np.float64)
