"""Site genotyping on the device: the FreeBayes numeric core as one torch
program.

The reference fans freebayes processes over genome windows
(bin/speedseq:704-719); each process walks its pileup and computes
per-sample genotype likelihoods, best genotypes, and site QUAL in C++
doubles.  Here the numeric core (per-read GL terms, per-sample
reductions, genotype masking/normalization, GQ, posterior QUAL, per-alt
placement/strand balance, and the pooled-discrete joint genotypes) is one
function over (sites, reads) tensors on the run's device:

  obs     (S, R) int8   read observation per site: -1 none, 0 ref, k alt k
  quals   (S, R) f32    phred observation quality
  sample  (S, R) int32  VCF sample column per read
  rpos    (S, R) int32  read-coordinate position at the site anchor (-1)
  strand  (S, R) int8   1 = reverse
  n_alts  (S,)   int32  live ALT count per site

R is the per-site compacted read axis (``compact_site_reads``).  The
counts (DP, RO, AO, RPL, RPR, SAF, SAR) are integer sums; QR and QA sum
the float qualities in float64 and truncate, as the reference truncates
its float32 sums.  The per-read log10 terms are computed in float64 and
rounded to float32, so both devices hold the same terms, and GL sums
them in float32 in read order, as the reference's float32 product does
on the CPU: cuda and cpu give the same GL.  The host keeps
candidate/locus construction (var.caller) and VCF text emission.
"""

from __future__ import annotations

import functools
import math
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.metrics import metrics
from .caller_space import GT_PAIRS, MAX_ALTS, N_GT

_PAIR_J = np.array([j for j, _ in GT_PAIRS], np.int64)
_PAIR_K = np.array([k for _, k in GT_PAIRS], np.int64)
_PAIR_MAX = np.maximum(_PAIR_J, _PAIR_K)
_PAIR_NONREF = (_PAIR_J > 0).astype(np.float32) + (_PAIR_K > 0)


class JointGenotypes(NamedTuple):
    gn: np.ndarray     # (S,) best normal genotype index (joint argmax)
    gt: np.ndarray     # (S,) best tumor genotype index
    gq: np.ndarray     # (S, 2) marginal genotype qualities
    qual: np.ndarray   # (S,) phred P(polymorphic) under the joint model


class SiteGenotypes(NamedTuple):
    """Device outputs (numpy after fetch); M = n_samples, A = MAX_ALTS."""

    gl: np.ndarray       # (S, M, G) f32 max-normalized log10 GL
    gt_idx: np.ndarray   # (S, M) int32 best genotype index into GT_PAIRS
    gq: np.ndarray       # (S, M) int32
    qual: np.ndarray     # (S,) f32 phred posterior P(polymorphic)
    dp: np.ndarray       # (S, M) int32
    ro: np.ndarray       # (S, M) int32
    ao: np.ndarray       # (S, M, A) int32
    qr: np.ndarray       # (S, M) int32
    qa: np.ndarray       # (S, M, A) int32
    rpl: np.ndarray      # (S, A) int32
    rpr: np.ndarray      # (S, A) int32
    saf: np.ndarray      # (S, A) int32
    sar: np.ndarray      # (S, A) int32
    joint: "JointGenotypes | None" = None  # pooled-discrete extras


def _genotype_sites_program(obs, quals, sample, rpos, strand, rlen_half,
                            n_alts, theta: float, lp_joint,
                            n_samples: int, pooled: bool):
    """The whole numeric core on the inputs' device.  Returns two tensors,
    f_out = [gl flat | site qual | joint qual] (float32) and i_out =
    [per-sample ints flat | rpl rpr saf sar | joint gn gt gq2] (int32),
    so the host fetches two leaves."""
    dev = obs.device
    S = obs.shape[0]
    A, G, M = MAX_ALTS, N_GT, n_samples
    obs = obs.to(torch.int64)
    e = torch.pow(10.0, -quals.double() / 10.0)               # (S, R)
    alleles = torch.arange(A + 1, device=dev)
    match = obs[..., None] == alleles                        # (S, R, A+1)
    p = torch.where(match, (1.0 - e)[..., None], (e / 3.0)[..., None])
    cover = obs >= 0
    pj = p[..., torch.as_tensor(_PAIR_J, device=dev)]        # (S, R, G)
    pk = p[..., torch.as_tensor(_PAIR_K, device=dev)]
    terms = torch.where(cover[..., None],
                        torch.log10(0.5 * pj + 0.5 * pk + 1e-30), 0.0
                        ).to(torch.float32)

    onehot = sample[..., None] == torch.arange(M, device=dev)  # (S, R, M)
    # per-sample GL: a float32 sum over the read axis in read order, the
    # order the reference's float32 product accumulates in on the CPU.  A
    # matrix product would sum in an order of the device's choosing, and
    # a float32 sum of ~depth terms moves with its order (by 6.7e-4
    # between cuBLAS on an H100 and the CPU at depth 200), enough to
    # break an exact genotype tie differently on the two devices
    gl = torch.zeros((S, M, G), dtype=torch.float32, device=dev)
    ohf = onehot.to(torch.float32)
    for r in range(obs.shape[1]):
        gl.addcmul_(ohf[:, r, :, None], terms[:, r, None, :])

    def count(x):                       # (S, R[, K]) bool → (S, M[, K])
        if x.dim() == 2:
            return (x[..., None] & onehot).sum(1, dtype=torch.int32)
        return (x[:, :, None, :] & onehot[..., None]).sum(
            1, dtype=torch.int32)

    def qsum(x):                        # float64 sum, truncated like astype
        q, oh = quals.double(), onehot.double()
        if x.dim() == 2:
            return torch.einsum("sr,srm->sm", torch.where(x, q, 0.0),
                                oh).to(torch.int32)
        return torch.einsum("sra,srm->sma", torch.where(x, q[..., None], 0.0),
                            oh).to(torch.int32)

    isref = obs == 0
    altb = obs[..., None] == torch.arange(1, A + 1, device=dev)   # (S, R, A)
    dp, ro, ao = count(cover), count(isref), count(altb)
    qr, qa = qsum(isref), qsum(altb)

    # per-alt placement / strand balance (pooled over samples)
    placed = altb & (rpos >= 0)[..., None]
    left = (rpos.to(torch.float32) < rlen_half)[..., None]
    rpl = (placed & left).sum(1, dtype=torch.int32)              # (S, A)
    rpr = placed.sum(1, dtype=torch.int32) - rpl
    saf = (altb & (strand == 0)[..., None]).sum(1, dtype=torch.int32)
    sar = altb.sum(1, dtype=torch.int32) - saf

    # genotype-space masking for each site's live ALT count
    invalid = (torch.as_tensor(_PAIR_MAX, device=dev)[None, :]
               > n_alts[:, None])                                # (S, G)
    gl = torch.where(invalid[:, None, :], -1e9, gl)
    gl_norm = gl - gl.max(dim=2, keepdim=True).values

    gt_idx = torch.argmax(gl_norm, dim=2).to(torch.int32)
    masked = torch.where(gl_norm < -1e8, -math.inf, gl_norm)
    top2 = torch.topk(masked, 2, dim=2).values
    gq = torch.clamp_max(torch.round(
        10.0 * (top2[..., 0] - torch.clamp_min(top2[..., 1], -1e9))),
        99).to(torch.int32)

    # posterior QUAL under the site-heterozygosity prior
    lt = torch.log10(torch.tensor(theta, dtype=torch.float32, device=dev))
    lp = torch.as_tensor(_PAIR_NONREF, device=dev) * lt              # (G,)
    w = torch.where(gl_norm < -1e8, -math.inf, gl_norm + lp)
    wmax = w.max(dim=2, keepdim=True).values
    logz = wmax[..., 0] + torch.log10(torch.pow(10.0, w - wmax).sum(2))
    log_p0 = (gl_norm[:, :, 0] + lp[0]) - logz                    # (S, M)
    qual = torch.clamp_max(-10.0 * log_p0.sum(1), 1e5)

    # pooled-discrete joint genotype combination over [normal, tumor],
    # inside the same program so somatic fetches nothing extra
    if pooled:
        j_gn, j_gt, j_gq, j_qual = _pooled_joint_core(gl_norm, lp_joint)
        joint_i = torch.cat([j_gn[:, None], j_gt[:, None], j_gq], dim=1)
    else:
        j_qual = torch.zeros(S, dtype=torch.float32, device=dev)
        joint_i = torch.zeros((S, 4), dtype=torch.int32, device=dev)

    i_sm = torch.cat([gt_idx[..., None], gq[..., None], dp[..., None],
                      ro[..., None], qr[..., None], ao, qa], dim=2)
    f_out = torch.cat([gl_norm.reshape(S, -1), qual[:, None],
                       j_qual[:, None]], dim=1)
    i_out = torch.cat([i_sm.reshape(S, -1), rpl, rpr, saf, sar, joint_i],
                      dim=1)
    return f_out, i_out


def _log10sumexp(x, dim):
    m = x.max(dim=dim).values
    return m + torch.log10(torch.pow(10.0, x - m.unsqueeze(dim)).sum(dim))


def _pooled_joint_core(gl, lp):
    """Joint discrete [normal, tumor] genotype combination.

    gl: (S, 2, G) max-normalized log10 per-sample GLs (invalid genotype
    slots ≈ -1e9); lp: (G, G) log10 combination prior.  Evaluates the
    full G×G joint posterior (the discrete space freebayes
    --pooled-discrete searches, bin/speedseq:1059-1067) instead of
    independent per-sample argmaxes."""
    S, _, G = gl.shape
    jl = gl[:, 0, :, None] + gl[:, 1, None, :] + lp[None]     # (S, G, G)
    flat = jl.reshape(S, G * G)
    best = torch.argmax(flat, dim=1)
    gn = torch.div(best, G, rounding_mode="floor").to(torch.int32)
    gt = (best % G).to(torch.int32)
    logz = _log10sumexp(flat, 1)

    def gq_of(marg):
        top2 = torch.topk(marg, 2, dim=1).values
        return torch.clamp_max(
            torch.round(10.0 * (top2[:, 0] - top2[:, 1])), 99
        ).to(torch.int32)

    gq = torch.stack([gq_of(_log10sumexp(jl, 2)),
                      gq_of(_log10sumexp(jl, 1))], dim=1)         # (S, 2)
    qual = torch.clamp_max(-10.0 * (jl[:, 0, 0] - logz), 1e5)
    return gn, gt, gq, qual


@functools.lru_cache(maxsize=8)
def _esf_log_prior_table(theta: float) -> np.ndarray:
    """(G, G) log10 prior over [normal, tumor] genotype combinations
    from the Ewens sampling formula on the pooled allele partition of
    the 4 chromosomes (freebayes models genotype-combination priors with
    the ESF; contract bin/speedseq:1059-1067 --pooled-discrete).

    For a combination whose pooled allele multiplicities are c_j with
    a_k = #{j : c_j = k}:  log10 P = Σ_j (log10 θ − log10 c_j)
    − Σ_k log10 a_k!  (the configuration-independent n!/θ_(n) factor
    cancels in argmax and normalization)."""
    lt = math.log10(theta)
    lp = np.zeros((N_GT, N_GT))
    for gn_i in range(N_GT):
        for gt_i in range(N_GT):
            cnt = Counter(list(GT_PAIRS[gn_i]) + list(GT_PAIRS[gt_i]))
            mult = Counter(cnt.values())
            v = sum(lt - math.log10(c) for c in cnt.values())
            v -= sum(math.log10(math.factorial(a)) for a in mult.values())
            lp[gn_i, gt_i] = v
    return lp.astype(np.float32)


def pooled_joint_genotypes(gl: np.ndarray, theta: float,
                           device=None) -> JointGenotypes:
    """The joint [normal, tumor] combination alone, for callers that
    already hold per-sample GLs (the var/somatic engine runs it inside
    the genotyping program instead), on ``device`` (cuda unless the
    caller asks for cpu).  gl: (S, 2, G) max-normalized log10 GLs."""
    device = resolve_device(device)
    lp = torch.from_numpy(_esf_log_prior_table(float(theta))).to(device)
    gl_t = torch.from_numpy(np.ascontiguousarray(gl, np.float32)).to(device)
    gn, gt, gq, qual = (x.cpu().numpy()
                        for x in _pooled_joint_core(gl_t, lp))
    return JointGenotypes(gn=gn, gt=gt, gq=gq, qual=qual)


def _bucket(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def compact_site_reads(
    obs: np.ndarray,
    quals: np.ndarray,
    sample: np.ndarray,     # (R,) per-window-read sample column
    rpos: np.ndarray,
    strand: np.ndarray,     # (R,)
    rlen_half: np.ndarray,  # (R,)
):
    """Per-site read compaction: gather each site's covering reads to
    the front and truncate the read axis to the (128-bucketed) max
    coverage — a window's read set is 100-1000× larger than any one
    site's coverage.  Returns the 6 compacted (S, Rc) arrays."""
    obs = np.asarray(obs, np.int8)
    quals = np.asarray(quals, np.float32)
    rpos = np.asarray(rpos, np.int32)
    sample = np.asarray(sample, np.int32)
    strand = np.asarray(strand, np.int8)
    rlen_half = np.asarray(rlen_half, np.float32)
    S, R = obs.shape
    cover = obs >= 0
    n_cov = cover.sum(axis=1)
    max_cov = int(n_cov.max()) if S else 0
    Rc = min(R, _bucket(max(max_cov, 1), 128))
    # stable partition via row-major nonzero ranks — O(nnz): within
    # each site row, nonzero() yields covering reads in read order,
    # so a read's destination slot is its index minus the row start
    idx = np.zeros((S, Rc), np.int32)
    s_i, r_i = np.nonzero(cover)
    row_start = np.zeros(S, np.int64)
    np.cumsum(n_cov[:-1], out=row_start[1:])
    dst = np.arange(len(s_i), dtype=np.int64) - row_start[s_i]
    keepm = dst < Rc
    idx[s_i[keepm], dst[keepm]] = r_i[keepm]
    obs = np.take_along_axis(obs, idx, 1)
    # slots beyond a site's coverage gathered read 0's values —
    # force them back to "no observation"
    invalid = np.arange(Rc)[None, :] >= n_cov[:, None]
    obs[invalid] = -1
    quals = np.take_along_axis(quals, idx, 1)
    rpos = np.take_along_axis(rpos, idx, 1)
    rpos[invalid] = -1
    return (obs, quals, sample[idx], rpos, strand[idx], rlen_half[idx])


def slice_genotypes(g: SiteGenotypes, lo: int, hi: int) -> SiteGenotypes:
    """Site-axis slice of a (possibly multi-window batched) result."""
    joint = None
    if g.joint is not None:
        joint = JointGenotypes(*(x[lo:hi] for x in g.joint))
    return SiteGenotypes(*(x[lo:hi] for x in g[:-1]), joint=joint)


def genotype_sites(
    obs: np.ndarray,
    quals: np.ndarray,
    sample: np.ndarray,
    rpos: np.ndarray,
    strand: np.ndarray,
    rlen_half: np.ndarray,
    n_alts: np.ndarray,
    theta: float,
    n_samples: int,
    device=None,
    pooled: bool = False,
    mesh=None,
) -> SiteGenotypes:
    """Host wrapper: compact the read axis per site (only covering
    reads), run the genotyping program on ``device`` (cuda unless the
    caller asks for cpu), fetch two leaves.

    ``sample``/``strand``/``rlen_half`` may be (R,) per-window-read
    arrays (compacted here together with obs) or pre-compacted (S, R)
    arrays.  ``mesh`` (a parallel.mesh.Mesh; ``device`` is then unused)
    shards the site axis: sites are padded to a multiple of 64 x the
    mesh size, each shard runs the program on its device, and the
    results are concatenated in shard order.  No value crosses sites,
    so the output is the unsharded one."""
    obs = np.asarray(obs, np.int8)
    quals = np.asarray(quals, np.float32)
    rpos = np.asarray(rpos, np.int32)
    sample = np.asarray(sample, np.int32)
    strand = np.asarray(strand, np.int8)
    rlen_half = np.asarray(rlen_half, np.float32)
    if sample.ndim == 1:
        obs, quals, sample, rpos, strand, rlen_half = compact_site_reads(
            obs, quals, sample, rpos, strand, rlen_half)
    S = obs.shape[0]
    pooled = bool(pooled and n_samples == 2)
    host = (obs, quals, sample, rpos, strand, rlen_half,
            np.asarray(n_alts, np.int32))

    def run(dev, arrays):
        lp = (torch.from_numpy(_esf_log_prior_table(float(theta))).to(dev)
              if pooled else None)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]
        f, i = _genotype_sites_program(
            *args, theta=float(theta), lp_joint=lp, n_samples=n_samples,
            pooled=pooled)
        metrics.add(f"var.genotype_programs.{dev.type}")
        return f.cpu().numpy(), i.cpu().numpy()

    if mesh is None:
        f_out, i_out = run(resolve_device(device), host)
    else:
        # pad rows: no observations, MAX_ALTS alleles (as the JAX pad)
        n = mesh.size
        Sp = _bucket(_bucket(S, 64), 64 * n)
        fills = (-1, 1.0, -1, -1, 0, 1.0, MAX_ALTS)
        padded = [np.concatenate([a, np.full((Sp - S,) + a.shape[1:], v,
                                             a.dtype)])
                  for a, v in zip(host, fills)]
        per = Sp // n
        outs = mesh.map(lambda s, dev: run(
            dev, [a[s * per:(s + 1) * per] for a in padded]))
        f_out = np.concatenate([o[0] for o in outs])[:S]
        i_out = np.concatenate([o[1] for o in outs])[:S]
    A, G, M = MAX_ALTS, N_GT, n_samples
    gl = f_out[:, : M * G].reshape(S, M, G)
    qual = f_out[:, M * G]
    w = 5 + 2 * A
    i_sm = i_out[:, : M * w].reshape(S, M, w)
    i_sa = i_out[:, M * w : M * w + 4 * A]
    joint = None
    if pooled:
        j_i = i_out[:, M * w + 4 * A :]
        joint = JointGenotypes(
            gn=j_i[:, 0], gt=j_i[:, 1], gq=j_i[:, 2:4],
            qual=f_out[:, M * G + 1])
    return SiteGenotypes(
        gl=gl, gt_idx=i_sm[..., 0], gq=i_sm[..., 1], qual=qual,
        dp=i_sm[..., 2], ro=i_sm[..., 3], qr=i_sm[..., 4],
        ao=i_sm[..., 5:5 + A], qa=i_sm[..., 5 + A:5 + 2 * A],
        rpl=i_sa[:, :A], rpr=i_sa[:, A:2 * A],
        saf=i_sa[:, 2 * A:3 * A], sar=i_sa[:, 3 * A:],
        joint=joint,
    )
