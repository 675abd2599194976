// Banded local affine-gap Smith-Waterman for Hopper (sm_90a): score-only
// and score + in-kernel traceback, behind a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of speedseq_tpu/ops/sw_pallas.py:
//   ssq_sw_cigar  <- sw_pallas_cigar (_mk_cigar_kernel, row step _row_ops)
//   ssq_sw_score  <- sw_pallas       (_mk_kernel, row step _row_ops)
// and computes exactly what they compute (bit-equal outputs; the plain
// PyTorch twins in ops/sw_banded.py are the executable specification).
//
// The DP runs in a moving diagonal frame: band column c = j - i in
// [0, BAND).  The diagonal neighbour of (i, c) is (i-1, c), the vertical one
// is (i-1, c+1), and the deletion state is a prefix max over the row capped
// at MAX_DEL = 64 columns (six doubling steps, not a full prefix max).
//
// What bounds it on this card: integer instructions.  Each band cell needs
// at least 11 int32 instructions of Hopper's (the substitution lookup, the
// vertical move, the capped window, H, the best-cell key; 23 with the
// traceback's direction word; ops/sw_banded.py:OPS_PER_CELL_*), against
// 132 SMs x 128 lanes x clock (four schedulers issue one warp instruction a
// clock each); a call reads ~(Lq + Lr) x 4 bytes and writes ~400 bytes
// per alignment, far below the memory roofline.  (The direction scratch of
// the traceback kernel, Lq x 128 x 4 bytes per alignment, is written once
// and read at a few cells.)
//
// The traceback kernel (sw_cigar_kernel): one warp per alignment with four
// adjacent band columns per thread, so the whole row lives in registers;
// the vertical move and every prefix-max step are warp shuffles (no shared
// memory, no block barriers); rows past the query length are skipped (they
// can neither hold the best cell nor be read by the traceback).  The
// traceback is serial, data-dependent control flow, so one thread of the
// warp walks it over the direction scratch, jumping whole diagonal runs.
// Narrower direction words, several alignments per warp and shared-memory
// tiling are left for later work.
//
// The score kernel (sw_score_kernel) has the same layout and was redesigned
// from the traceback kernel's row, which once served both (its score path:
// 195 SASS instructions and 22 shuffles a row, 5 global loads; PERF.md §6):
//   - no global loads in the row loop: the warp first stages its window as
//     one 32-bit PRMT selector a column (rc * 0x1111 + 0x8880) and its
//     query as one 8-byte table a row (sub(q[i], rc) as int8: rc = 0..3,
//     4 for N or a code above 4, 5 for a negative code) in shared memory; a
//     row reads its table (a broadcast) and a thread's next four columns
//     come every four rows in one 16-byte load, so a cell's substitution
//     score is one PRMT (sign-extending byte select).  Scores that do not
//     fit int8 take the same kernel with the substitution computed by
//     compares (LUT = false; 19 % slower);
//   - the 64-column deletion window max in 11 shuffles on 2 dependent
//     rounds, not 20 on 7, with the previous column's max folded in: lanes
//     l-4 .. l-1 in one round of four shuffles, then lanes l-15 .. l-1 in
//     one of three, and lane l-16's suffix maxima in four shuffles of 16;
//   - per-row work that only one row needs left the loop: qlen < 1 is a
//     case of its own (no `valid` selects), gbest is taken once from the
//     last row, and the best-cell key is one multiply-add a cell against a
//     row term, its column term subtracted after the loop.
// That leaves 13 shuffles and ~87 SASS instructions a row.
// What bounds it: at the mate-rescue launch (768 lanes, one warp a block)
// the busiest of the 528 SM partitions runs two alignments, the average
// 1.45, so no one-warp-per-alignment design passes 1.45 / 2 = 73 % of the
// instruction bound there, and the row's dependent chain (the vertical
// shuffle, two window rounds, F) sets its pace: ~345 clocks a row.  At
// 32,768 lanes (score_mode="sw" phase 1) the instructions do: ~123 clocks
// a warp-row, ~1.4 an instruction, as in the traceback kernel's row.

#include <cuda_runtime.h>
#include <stdint.h>

#define BAND 128
#define NEG (-1000000)
#define WARPS_PER_BLOCK 4
#define MAX_OPS_CAP 64
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ int shfl_up_or(int v, int d, int lane, int fill) {
  int u = __shfl_up_sync(FULL_MASK, v, d);
  return lane < d ? fill : u;
}

// One warp per alignment.  Lane l owns band columns 4l .. 4l+3.
// out rows (stride out_stride):
//   score, qbeg, qend, rbeg, rend, gscore, grend, n_ops, nm
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_cigar_kernel(const int* __restrict__ query, const int* __restrict__ qlens,
                 const int* __restrict__ ref, int n_lanes, int Lq, int Lr,
                 int p_match, int p_mis, int p_open, int p_ext, int max_ops,
                 int* __restrict__ dirs, int* __restrict__ out, long out_stride,
                 int* __restrict__ ops_out, int* __restrict__ lens_out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (n >= n_lanes) return;  // warp-uniform
  const int qlen = qlens[n];
  const int* q = query + (long)n * Lq;
  const int* r = ref + (long)n * Lr;
  int* drow = dirs + (long)n * Lq * BAND;
  const int oe = p_open + p_ext;
  const int c0 = lane * 4;

  int H[4], V[4], best[4], gbest[4], runs[4], misrun[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    H[t] = 0; V[t] = NEG; best[t] = 0; gbest[t] = 0; runs[t] = 0; misrun[t] = 0;
  }
  // rows >= qlen are invalid (H = 0, packed direction 0): their best-cell
  // keys stay below row 0's, and the traceback never reads them
  int rows = qlen < 1 ? 1 : qlen;
  if (rows > Lq) rows = Lq;

  for (int i = 0; i < rows; ++i) {
    const int qc = q[i];
    const bool valid = i < qlen;
    const bool q_ok = qc < 4;
    int Hup = __shfl_down_sync(FULL_MASK, H[0], 1);
    int Vup = __shfl_down_sync(FULL_MASK, V[0], 1);
    if (lane == 31) { Hup = NEG; Vup = NEG; }
    const int Hv[4] = {H[1], H[2], H[3], Hup};
    const int Vv[4] = {V[1], V[2], V[3], Vup};
    int diag[4], Vn[4], Ht[4], vext[4], mis[4], x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = i + c0 + t;
      const int rw = j < Lr ? r[j] : 4;  // columns past the window read as N
      const bool r_ok = rw < 4;
      const bool match = q_ok && r_ok && rw == qc;
      const int sub = (q_ok && r_ok) ? (match ? p_match : -p_mis) : -1;
      diag[t] = H[t] + sub;
      const int a = Vv[t] - p_ext, b = Hv[t] - oe;
      Vn[t] = max(a, b);
      vext[t] = a >= b;
      Ht[t] = max(max(diag[t], Vn[t]), 0);
      mis[t] = !match;
      x[t] = Ht[t] + p_ext * (c0 + t);
    }
    // prefix max over the previous 64 columns: steps 1, 2 (within and across
    // neighbouring lanes), then 4, 8, 16, 32 columns = 1, 2, 4, 8 lanes
    {
      const int u3 = shfl_up_or(x[3], 1, lane, NEG);
      const int y0 = max(x[0], u3), y1 = max(x[1], x[0]);
      const int y2 = max(x[2], x[1]), y3 = max(x[3], x[2]);
      x[0] = y0; x[1] = y1; x[2] = y2; x[3] = y3;
    }
    {
      const int u2 = shfl_up_or(x[2], 1, lane, NEG);
      const int u3 = shfl_up_or(x[3], 1, lane, NEG);
      const int y0 = max(x[0], u2), y1 = max(x[1], u3);
      const int y2 = max(x[2], x[0]), y3 = max(x[3], x[1]);
      x[0] = y0; x[1] = y1; x[2] = y2; x[3] = y3;
    }
#pragma unroll
    for (int d = 1; d <= 8; d <<= 1) {
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = max(x[t], shfl_up_or(x[t], d, lane, NEG));
    }
    // pm[c] = x[c-1]; pm_prev[c] = pm[c-1]; both NEG at c = 0
    const int xu = shfl_up_or(x[3], 1, lane, NEG);
    const int pm[4] = {xu, x[0], x[1], x[2]};
    const int pu = shfl_up_or(pm[3], 1, lane, NEG);
    const int pmp[4] = {pu, pm[0], pm[1], pm[2]};
    int packed[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = c0 + t;
      const int F = pm[t] - p_open - p_ext * c;
      const int Hn = max(Ht[t], F);
      // tie order: D first, then I, then diagonal (diagonal wins ties)
      int d = 0;
      if (Hn == F && Hn > 0) d = 3;
      if (Hn == Vn[t] && Hn > 0) d = 2;
      if (Hn == diag[t] && Hn > 0) d = 1;
      const int Hm = valid ? Hn : 0;
      V[t] = valid ? Vn[t] : NEG;
      H[t] = Hm;
      const int fext = (pm[t] == pmp[t]) && c > 0;
      const int rn = d == 1 ? min(runs[t] + 1, 127) : 0;
      const int mr = d == 1 ? min(misrun[t] + mis[t], 127) : 0;
      runs[t] = rn;
      misrun[t] = mr;
      const int pk = d | (vext[t] << 2) | (fext << 3) | (mis[t] << 4) |
                     (rn << 5) | (mr << 12);
      packed[t] = valid ? pk : 0;
      const int jg = i + c;
      const int cand = (Hm * (Lq + 1) + (Lq - i)) * Lr + (Lr - 1 - jg);
      best[t] = max(best[t], cand);
      if (i == qlen - 1) gbest[t] = Hm * Lr + (Lr - 1 - jg);
    }
    *reinterpret_cast<int4*>(drow + (long)i * BAND + c0) =
        make_int4(packed[0], packed[1], packed[2], packed[3]);
  }

  int b = max(max(best[0], best[1]), max(best[2], best[3]));
  int g = max(max(gbest[0], gbest[1]), max(gbest[2], gbest[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b = max(b, __shfl_xor_sync(FULL_MASK, b, o));
    g = max(g, __shfl_xor_sync(FULL_MASK, g, o));
  }
  // both keys are >= 0 (row 0, column 0 bounds them; the wrapper requires
  // Lq <= Lr), so C division matches the reference's floor division
  const int M = (Lq + 1) * Lr;
  const int score = b / M;
  const int rem = b % M;
  const int qend = Lq - rem / Lr + 1;
  const int rend = Lr - 1 - rem % Lr + 1;
  const int gscore = g / Lr;
  const int grend = Lr - 1 - g % Lr + 1;
  __syncwarp();  // the direction scratch written above is visible to lane 0
  if (lane != 0) return;

  // ---- traceback: walk (i, j) in global coordinates from the best cell
  int lops[MAX_OPS_CAP], llens[MAX_OPS_CAP];
  for (int t = 0; t < max_ops; ++t) { lops[t] = 0; llens[t] = 0; }
  int i = qend - 1, j = rend - 1, mode = 0, kop = 0, cur_op = -1, cur_len = 0;
  int nm = 0;
  const int limit = Lq + Lr;
  for (int steps = 0; steps < limit; ++steps) {
    const int ii = min(max(i, 0), Lq - 1);
    const int cc = min(max(j - i, 0), BAND - 1);
    const int p = ii < rows ? drow[(long)ii * BAND + cc] : 0;
    const int d = p & 3, ve = (p >> 2) & 1, fe = (p >> 3) & 1;
    const bool oob = i < 0 || j < 0 || j - i < 0 || j - i >= BAND;
    const int de = mode == 1 ? 2 : (mode == 2 ? 3 : (oob ? 0 : d));
    const bool fin = de == 0;
    const int op = de == 1 ? 0 : (de == 2 ? 1 : 2);
    const int step = de == 1 ? max((p >> 5) & 127, 1) : 1;
    const int nm_add = de == 1 ? (p >> 12) & 127 : 1;
    const bool change = !fin && cur_len > 0 && op != cur_op;
    if (change || (fin && cur_len > 0)) {
      const int kf = min(max(kop, 0), max_ops - 1);  // overflow: last slot
      lops[kf] = cur_op;
      llens[kf] = cur_len;
      ++kop;
    }
    if (fin) break;
    cur_len = change ? step : cur_len + step;
    cur_op = op;
    nm += nm_add;
    if (de == 1) { i -= step; j -= step; }
    else if (de == 2) { i -= 1; }
    else { j -= 1; }
    mode = (de == 2 && ve) ? 1 : ((de == 3 && fe) ? 2 : 0);
  }
  const int nops = min(max(kop, 0), max_ops);
  int* po = ops_out + (long)n * max_ops;
  int* pl = lens_out + (long)n * max_ops;
  for (int t = 0; t < max_ops; ++t) {  // the walk ran end -> start
    po[t] = t < nops ? lops[nops - 1 - t] : 0;
    pl[t] = t < nops ? llens[nops - 1 - t] : 0;
  }
  out[0 * out_stride + n] = score;
  out[1 * out_stride + n] = i + 1;
  out[2 * out_stride + n] = qend;
  out[3 * out_stride + n] = j + 1;
  out[4 * out_stride + n] = rend;
  out[5 * out_stride + n] = gscore;
  out[6 * out_stride + n] = grend;
  out[7 * out_stride + n] = nops;
  out[8 * out_stride + n] = nm;
}

inline dim3 grid_for(int n) {
  return dim3((unsigned)((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
}

// ---------------------------------------------------------------- score-only
#define SCORE_WARPS 1  // 1, 2 and 4 measured: PERF.md §6
#define MAX_LR 256
// window columns a row may read: j = i + 4l + t < Lq + 127, and the next
// four columns' load past the last row, i0 + 4 + 4l + 3 < 384
#define WIN_COLS (MAX_LR + BAND)

__device__ __forceinline__ int prmt(unsigned a, unsigned b, unsigned sel) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return (int)r;
}

// max(v, shfl_up(v, d)): a lane below d gets its own v back, which already
// lies inside the window it asks for
__device__ __forceinline__ int max_up(int v, int d) {
  return max(v, __shfl_up_sync(FULL_MASK, v, d));
}

struct ScoreConst {
  int p_match, p_mis, p_ext, oe, K, dR;
  int ec[4], fo[4];  // p_ext * c and p_open + p_ext * c of the thread's columns
};

// One band row of 4 columns a thread.  win[t]: column c0+t's selector (LUT)
// or ref code; tab: the row's table (LUT) or query code in .x.
template <bool LUT>
__device__ __forceinline__ void score_row(int (&H)[4], int (&V)[4],
                                          int (&bk)[4], int& R, uint2 tab,
                                          const unsigned (&win)[4],
                                          const ScoreConst& k, int lane) {
  int sm = 0, smis = 0;
  if (!LUT) {
    const bool q_ok = (int)tab.x < 4;
    sm = q_ok ? k.p_match : -1;
    smis = q_ok ? -k.p_mis : -1;
  }
  int Hup = __shfl_down_sync(FULL_MASK, H[0], 1);
  int Vup = __shfl_down_sync(FULL_MASK, V[0], 1);
  if (lane == 31) { Hup = NEG; Vup = NEG; }
  const int Hv[4] = {H[1], H[2], H[3], Hup};
  const int Vv[4] = {V[1], V[2], V[3], Vup};
  int Ht[4], x[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int rc = (int)win[t];
    const int sub = LUT ? prmt(tab.x, tab.y, win[t])
                        : (rc == (int)tab.x ? sm : (rc == 4 ? -1 : smis));
    V[t] = max(Vv[t] - k.p_ext, Hv[t] - k.oe);
    Ht[t] = max(max(H[t] + sub, V[t]), 0);
    x[t] = Ht[t] + k.ec[t];
  }
  // deletion window: pm[c] = max x over [c-64, c-1], c = 4l + t
  const int x01 = max(x[0], x[1]), x23 = max(x[2], x[3]);
  const int m = max(x01, x23);
  // lane l-16's suffix maxima (NEG below lane 16)
  const int m16 = shfl_up_or(m, 16, lane, NEG);
  const int s1 = shfl_up_or(max(x[1], x23), 16, lane, NEG);
  const int s2 = shfl_up_or(x23, 16, lane, NEG);
  const int s3 = shfl_up_or(x[3], 16, lane, NEG);
  // B = max m over lanes l-4 .. l-1, then W over lanes l-15 .. l-1: two
  // rounds of shuffles (NEG on lane 0)
  const int B = max(max(shfl_up_or(m, 1, lane, NEG), shfl_up_or(m, 2, lane, NEG)),
                    max(shfl_up_or(m, 3, lane, NEG), shfl_up_or(m, 4, lane, NEG)));
  const int W = max(max_up(B, 4), max(__shfl_up_sync(FULL_MASK, B, 8),
                                      __shfl_up_sync(FULL_MASK, B, 11)));
  const int pm[4] = {max(W, m16), max(max(x[0], W), s1),
                     max(max(x01, W), s2), max(max(max(x01, x[2]), W), s3)};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    H[t] = max(Ht[t], pm[t] - k.fo[t]);
    bk[t] = max(bk[t], H[t] * k.K + R);
  }
  R -= k.dR;
}

// One warp per alignment, lane l owns band columns 4l .. 4l+3.  Outputs:
// score, qend, rend, gscore, grend.
template <bool LUT>
__global__ void __launch_bounds__(SCORE_WARPS * 32)
sw_score_kernel(const int* __restrict__ query, const int* __restrict__ qlens,
                const int* __restrict__ ref, int n_lanes, int Lq, int Lr,
                int p_match, int p_mis, int p_open, int p_ext,
                int* __restrict__ out, long out_stride) {
  __shared__ __align__(16) unsigned win_s[SCORE_WARPS][WIN_COLS];
  __shared__ uint2 tab_s[SCORE_WARPS][MAX_LR + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * SCORE_WARPS + w;
  if (n >= n_lanes) return;  // warp-uniform
  const int qlen = qlens[n];
  // keys as the cigar kernel's: both >= 0, so C division matches floor
  // division
  int b = 0, g = 0;
  if (qlen < 1) {
    // a dead lane: row 0 with H = 0 (the cigar kernel's invalid row)
    b = Lq > 0 ? Lq * Lr + Lr - 1 : 0;
  } else {
    unsigned* win = win_s[w];
    uint2* tab = tab_s[w];
    const int* q = query + (long)n * Lq;
    const int* r = ref + (long)n * Lr;
    for (int j = lane; j < WIN_COLS; j += 32) {
      int rc = j < Lr ? r[j] : 4;  // columns past the window read as N
      rc = rc < 0 ? 5 : min(rc, 4);  // a negative code mismatches every base
      win[j] = LUT ? (unsigned)rc * 0x1111u + 0x8880u : (unsigned)rc;
    }
    for (int i = lane; i < Lq; i += 32) {
      const int qc = q[i];
      uint2 e = make_uint2((unsigned)qc, 0u);
      if (LUT) {  // byte rc = sub(qc, rc); byte 4 (N) -1, 5 (negative) mismatch
        e.x = 0;
#pragma unroll
        for (int rc = 0; rc < 4; ++rc) {
          const int s = qc < 4 ? (rc == qc ? p_match : -p_mis) : -1;
          e.x |= ((unsigned)s & 0xffu) << (8 * rc);
        }
        e.y = 0xffu | ((unsigned)(qc < 4 ? -p_mis : -1) & 0xffu) << 8;
      }
      tab[i] = e;
    }
    __syncwarp();

    const int c0 = lane * 4;
    ScoreConst k;
    k.p_match = p_match; k.p_mis = p_mis; k.p_ext = p_ext;
    k.oe = p_open + p_ext;
    k.K = (Lq + 1) * Lr;
    k.dR = Lr + 1;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      k.ec[t] = p_ext * (c0 + t);
      k.fo[t] = p_open + k.ec[t];
    }
    // bk[t] = max over rows of H * K + R_i, R_i = K - 1 - i (Lr + 1): the
    // cigar kernel's key (H (Lq+1) + Lq - i) Lr + Lr - 1 - (i + c) plus c
    int H[4] = {0, 0, 0, 0}, V[4] = {NEG, NEG, NEG, NEG}, bk[4] = {0, 0, 0, 0};
    int R = k.K - 1;
    const int rows = min(qlen, Lq);
    uint4 cur = *reinterpret_cast<const uint4*>(win + c0);
    uint2 t0 = tab[0];
    for (int i0 = 0; i0 < rows; i0 += 4) {
      const uint4 nx = *reinterpret_cast<const uint4*>(win + i0 + 4 + c0);
      const unsigned cat[8] = {cur.x, cur.y, cur.z, cur.w,
                               nx.x, nx.y, nx.z, nx.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s > 0 && i0 + s >= rows) break;  // warp-uniform
        const uint2 t1 = tab[i0 + s + 1];
        const unsigned wv[4] = {cat[s], cat[s + 1], cat[s + 2], cat[s + 3]};
        score_row<LUT>(H, V, bk, R, t0, wv, k, lane);
        t0 = t1;
      }
      cur = nx;
    }
    b = max(max(bk[0] - c0, bk[1] - c0 - 1), max(bk[2] - c0 - 2,
                                                 bk[3] - c0 - 3));
    if (qlen <= Lq) {  // H is row qlen - 1
#pragma unroll
      for (int t = 0; t < 4; ++t)
        g = max(g, H[t] * Lr + (Lr - qlen - c0 - t));
    }
  }
  b = __reduce_max_sync(FULL_MASK, b);
  g = __reduce_max_sync(FULL_MASK, g);
  if (lane == 0) {
    const int M = (Lq + 1) * Lr;
    const int rem = b % M;
    out[0 * out_stride + n] = b / M;
    out[1 * out_stride + n] = Lq - rem / Lr + 1;
    out[2 * out_stride + n] = Lr - 1 - rem % Lr + 1;
    out[3 * out_stride + n] = g / Lr;
    out[4 * out_stride + n] = Lr - 1 - g % Lr + 1;
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous int32 arrays:
// query (n, Lq), qlen (n,), ref (n, Lr), dirs (n, Lq, 128) scratch,
// out (9, out_stride) starting at this chunk's first lane, ops/lens (n, max_ops).
// Returns cudaGetLastError() after the launch.
int ssq_sw_cigar(const void* query, const void* qlen, const void* ref, int n,
                 int Lq, int Lr, int p_match, int p_mis, int p_open, int p_ext,
                 int max_ops, void* dirs, void* out, long out_stride, void* ops,
                 void* lens, void* stream) {
  if (n <= 0) return 0;
  sw_cigar_kernel<<<grid_for(n), WARPS_PER_BLOCK * 32, 0,
                    (cudaStream_t)stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr, p_match,
      p_mis, p_open, p_ext, max_ops, (int*)dirs, (int*)out, out_stride,
      (int*)ops, (int*)lens);
  return (int)cudaGetLastError();
}

// out (5, out_stride): score, qend, rend, gscore, grend.
int ssq_sw_score(const void* query, const void* qlen, const void* ref, int n,
                 int Lq, int Lr, int p_match, int p_mis, int p_open, int p_ext,
                 void* out, long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr > MAX_LR) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + SCORE_WARPS - 1) / SCORE_WARPS));
  // the int8 table holds p_match, -p_mis and -1
  const bool lut = p_match >= -128 && p_match <= 127 && p_mis >= -127 &&
                   p_mis <= 128;
  if (lut)
    sw_score_kernel<true><<<grid, SCORE_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr,
        p_match, p_mis, p_open, p_ext, (int*)out, out_stride);
  else
    sw_score_kernel<false><<<grid, SCORE_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr,
        p_match, p_mis, p_open, p_ext, (int*)out, out_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
