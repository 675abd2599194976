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
// What bounds both on this card: integer instructions.  Each band cell
// needs at least 11 int32 instructions of Hopper's (the substitution
// lookup, the vertical move, the capped window, H, the best-cell key; 19
// with the traceback's 4-bit direction code;
// ops/sw_banded.py:OPS_PER_CELL_*), against 132 SMs x 128 lanes x clock
// (four schedulers start one warp instruction a clock each); a call reads
// ~(Lq + Lr) x 4 bytes and writes at most ~400 bytes per alignment.
//
// The score kernel (sw_score_kernel) was redesigned from the old traceback
// kernel's row, which once served both (its score path: 195 SASS
// instructions and 22 shuffles a row, 5 global loads; PERF.md §6):
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
// 32,768 lanes (every chain of an 8,192-read batch end) the instructions
// do: ~123 clocks a warp-row, ~1.4 an instruction.
//
// The traceback kernel (sw_cigar_kernel) runs the score kernel's row (one
// code for both: stage, make_const, row_front and del_window, whose fill
// is a parameter) and adds a 4-bit direction code a cell:
// the move by the D, I, diagonal tie order, the I-extend bit and the
// D-extend bit (which needs one more shuffle a row, for column 4l - 1).
//   - no compare or branch decides the move: its two bits are the signs of
//     two 3-input logic ops on diag - H, V - H and -H, the I-extend bit
//     the sign of Hv - Vv - o - 1, each funnel-shifted into the thread's
//     16-bit code (cigar_row), and the window's fills are adds of a large
//     negative number (PenFill), not selects of NEG (the score kernel's
//     NegFill, kept there for its SASS): the row is held by the ALU pipe
//     (64 lanes a clock per SM runs its selects, compares, min/max, logic
//     and shifts; adds can go to the FMA pipe's IMAD), so what leaves the
//     ALU pipe is what counts;
//   - the code is one 16-bit shared-memory store a row into the warp's
//     code table, laid out [thread][row] with a row pitch of P = 2 mod 4
//     halfwords, so that the 32 stores of a row fall in 32 distinct banks
//     and so do the walk's reads of one column's 32 rows.  The table is
//     Lq x 64 bytes a warp (9.7 KB at Lq = 151), beside 2.7 KB of staged
//     window and query, all in dynamic shared memory: nothing goes to a
//     scratch in device memory (the word a cell that the kernel once wrote
//     there was 1.27 GB a launch at 16,384 lanes; a table of these codes
//     in device memory measured no faster).
// The twin's word keeps 15 more bits (the mismatch bit, a 7-bit diagonal
// run and the run's mismatches, saturating at 127); the walk re-derives
// them where it needs them, at the diagonal cells it stands on:
//   - the walk is warp-wide, its state the same in every lane.  At a
//     diagonal cell the 32 lanes read 32 rows of the cell's band column at
//     a time: a ballot of "not a diagonal move" finds where the chain
//     starts, a popcount of the ballot of mismatches (the staged query and
//     window: !(q < 4 && q == r), a column past the window reads as N and
//     a negative ref code mismatches) counts the chain's mismatches.  The
//     jump is min(chain, 127) rows and NM gains the mismatches of the
//     rows the jump covers, as the twin's saturating fields give it (the
//     run's count at the cell less its count at the landing cell, which
//     lies inside the run when the chain is longer than 127): a mismatch
//     counts once however long its chain (the reference counts the
//     whole chain at each jump, so it counts some twice);
//   - gap moves step one cell, reading one code (a broadcast);
//   - the op buffer is two registers a lane (slots l and l + 32, op | len
//     << 2), written back reversed by two shuffles a lane, coalesced.
// At 16,384 lanes the row is ~140 SASS instructions, ~75 of them on the
// ALU pipe, at ~82 % of that pipe's rate (PERF.md §6); the walk is ~2 %
// of the time.  One warp a block: a block keeps its shared memory until
// its last alignment ends, so bigger blocks measured slower.

#include <cuda_runtime.h>
#include <stdint.h>

#define BAND 128
#define NEG (-1000000)
#define MAX_OPS_CAP 64
#define FULL_MASK 0xffffffffu
#define SCORE_WARPS 1  // 1, 2 and 4 measured: PERF.md §6
#define CIGAR_WARPS 1
#define MAX_LR 256
// window columns a row may read: j = i + 4l + t < Lq + 127, and the next
// four columns' load past the last row, i0 + 4 + 4l + 3 < 384
#define WIN_COLS (MAX_LR + BAND)

namespace {

__device__ __forceinline__ int shfl_up_or(int v, int d, int lane, int fill) {
  int u = __shfl_up_sync(FULL_MASK, v, d);
  return lane < d ? fill : u;
}

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

// The front of a band row of 4 columns a thread, shared by both kernels:
// the vertical move, the substitution, V, diag = H + sub, Ht and x = Ht +
// e c, and the I-extend test iext (< 0: Vv - e >= Hv - o - e), which the
// score kernel leaves unused.  win[t]: column c0+t's selector (LUT) or ref
// code; tab: the row's table (LUT) or query code in .x.
template <bool LUT>
__device__ __forceinline__ void row_front(const int (&H)[4], int (&V)[4],
                                          uint2 tab, const unsigned (&win)[4],
                                          const ScoreConst& k, int lane,
                                          int (&diag)[4], int (&Ht)[4],
                                          int (&x)[4], int (&iext)[4]) {
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
  const int o1 = k.oe - k.p_ext + 1;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int rc = (int)win[t];
    const int sub = LUT ? prmt(tab.x, tab.y, win[t])
                        : (rc == (int)tab.x ? sm : (rc == 4 ? -1 : smis));
    iext[t] = Hv[t] - Vv[t] - o1;
    V[t] = max(Vv[t] - k.p_ext, Hv[t] - k.oe);
    diag[t] = H[t] + sub;
    Ht[t] = max(max(diag[t], V[t]), 0);
    x[t] = Ht[t] + k.ec[t];
  }
}

// The deletion window of a row: pm[t] = max x over columns [c-64, c-1], c
// = 4l + t, in 11 shuffles on 2 dependent rounds.  fill.up(v, d, f) is lane
// l-d's v, or a fill where l < d (f numbers the distances 1, 2, 3, 4, 16).
template <class Fill>
__device__ __forceinline__ void del_window(const int (&x)[4], const Fill& fill,
                                           int (&pm)[4]) {
  const int x01 = max(x[0], x[1]), x23 = max(x[2], x[3]);
  const int m = max(x01, x23);
  // lane l-16's suffix maxima
  const int m16 = fill.up(m, 16, 4);
  const int s1 = fill.up(max(x[1], x23), 16, 4);
  const int s2 = fill.up(x23, 16, 4);
  const int s3 = fill.up(x[3], 16, 4);
  // B = max m over lanes l-4 .. l-1, then W over lanes l-15 .. l-1: two
  // rounds of shuffles (the fill on lane 0)
  const int B = max(max(fill.up(m, 1, 0), fill.up(m, 2, 1)),
                    max(fill.up(m, 3, 2), fill.up(m, 4, 3)));
  const int W = max(max_up(B, 4), max(__shfl_up_sync(FULL_MASK, B, 8),
                                      __shfl_up_sync(FULL_MASK, B, 11)));
  pm[0] = max(W, m16);
  pm[1] = max(max(x[0], W), s1);
  pm[2] = max(max(x01, W), s2);
  pm[3] = max(max(max(x01, x[2]), W), s3);
}

// The score kernel's fill: NEG selected below lane d.
struct NegFill {
  int lane;
  __device__ __forceinline__ int up(int v, int d, int) const {
    return shfl_up_or(v, d, lane, NEG);
  }
};

// One band row of 4 columns a thread (the score kernel).
template <bool LUT>
__device__ __forceinline__ void score_row(int (&H)[4], int (&V)[4],
                                          int (&bk)[4], int& R, uint2 tab,
                                          const unsigned (&win)[4],
                                          const ScoreConst& k, int lane) {
  int diag[4], Ht[4], x[4], iext[4], pm[4];
  row_front<LUT>(H, V, tab, win, k, lane, diag, Ht, x, iext);
  del_window(x, NegFill{lane}, pm);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    H[t] = max(Ht[t], pm[t] - k.fo[t]);
    bk[t] = max(bk[t], H[t] * k.K + R);
  }
  R -= k.dR;
}

// Both kernels' staging: the window's selectors (LUT) or codes, and each
// query row's table (LUT) or code in .x; with CLS (the cigar kernel) the
// row's query class (its code, 4 for N or any code outside 0..3) in bits
// 16-23 of .y, for the walk's mismatch test (no selector reads that byte).
template <bool LUT, bool CLS>
__device__ __forceinline__ void stage(unsigned* win, uint2* tab,
                                      const int* q, const int* r, int Lq,
                                      int Lr, int p_match, int p_mis,
                                      int lane) {
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
    if (CLS) e.y |= ((unsigned)qc < 4u ? (unsigned)qc : 4u) << 16;
    tab[i] = e;
  }
}

// Both kernels' constants for the thread's columns c0 .. c0+3.
__device__ __forceinline__ ScoreConst make_const(int Lq, int Lr, int p_match,
                                                 int p_mis, int p_open,
                                                 int p_ext, int c0) {
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
  return k;
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
    stage<LUT, false>(win, tab, query + (long)n * Lq, ref + (long)n * Lr,
                      Lq, Lr, p_match, p_mis, lane);
    __syncwarp();

    const int c0 = lane * 4;
    const ScoreConst k = make_const(Lq, Lr, p_match, p_mis, p_open, p_ext, c0);
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


// ---------------------------------------------------------------- traceback

// Halfwords a thread's row of codes takes in the code table: at least Lq,
// and 2 mod 4, so that 32 threads' halfwords of one row, and 32 rows of one
// thread, lie in 32 distinct banks.
__host__ __device__ inline int code_pitch(int Lq) {
  return ((Lq + 1) & ~3) + 2;
}

// Shared bytes a warp of the cigar kernel takes: window selectors, the
// query rows' tables (Lq + 1 of them, padded to 16 bytes), the code table.
__host__ __device__ inline int cigar_warp_bytes(int Lq) {
  return 4 * WIN_COLS + 16 * ((Lq + 2) / 2) + 64 * code_pitch(Lq);
}

// The cigar row's fill: FILL_PEN added below lane d (pen[f] is FILL_PEN
// or 0), an add, which the FMA pipe can run, instead of a select of NEG,
// on the ALU pipe that bounds the row: every column but c = 0 has a real
// value (x >= 0) in its window, so pm is the same there, and at c = 0
// both fills leave F below Ht.
#define FILL_PEN (-(1 << 30))

struct PenFill {
  const int (&pen)[5];
  __device__ __forceinline__ int up(int v, int d, int f) const {
    return __shfl_up_sync(FULL_MASK, v, d) + pen[f];
  }
};

// The score row plus the cells' direction codes, 4 bits a column: for
// column c0 + t, the move d (bits 3t, 3t+1: 0 stop, 1 diagonal, 2
// insertion, 3 deletion; the diagonal wins ties, then I, then D) and the
// insertion's extend bit (3t+2: V came from V, not from H), and at bit
// 12 + t the deletion's (pm[c] == pm[c-1]: the window's maximum reached
// column c-1 too).  Branch-free: d's bits are the signs of
//   b1 = -H & (diag - H)              a gap move (the diagonal loses),
//   b0 = -H & ((V - H) | ~(diag - H)) a diagonal or a deletion,
// the I-extend bit the sign of Hv - Vv - o - 1, each shifted into the
// code by one funnel shift.
template <bool LUT>
__device__ __forceinline__ unsigned cigar_row(int (&H)[4], int (&V)[4],
                                              int (&bk)[4], int& R,
                                              uint2 tab,
                                              const unsigned (&win)[4],
                                              const ScoreConst& k,
                                              const int (&pen)[5], int lane) {
  int diag[4], Ht[4], x[4], iext[4], pm[4];
  row_front<LUT>(H, V, tab, win, k, lane, diag, Ht, x, iext);
  del_window(x, PenFill{pen}, pm);
  const int pm_left = __shfl_up_sync(FULL_MASK, pm[3], 1);  // pm[c0 - 1]
  unsigned code = 0, dext = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 3 - u;  // the code's low bits are column c0's
    const int Hn = max(Ht[t], pm[t] - k.fo[t]);
    const int X = diag[t] - Hn, Y = V[t] - Hn, Z = -Hn;
    code = __funnelshift_l((unsigned)iext[t], code, 1);
    code = __funnelshift_l((unsigned)(Z & X), code, 1);
    code = __funnelshift_l((unsigned)(Z & (Y | ~X)), code, 1);
    if (t > 0 ? pm[t] == pm[t - 1] : (pm[0] == pm_left && lane > 0))
      dext |= 1u << t;
    H[t] = Hn;
    bk[t] = max(bk[t], Hn * k.K + R);
  }
  R -= k.dR;
  return code | dext << 12;
}

// A diagonal move at (i, c): the chain of diagonal moves in band column c
// that ends at row i (the 32 lanes read 32 rows of it at a time) gives the
// jump, min(chain, 127), and NM's increase, the mismatches of the jumped
// rows: min(all the chain's, 127) less min(those past the jump, 127), the
// twin's saturating counts at the cell and at the landing cell.
__device__ __forceinline__ void diag_chain(const unsigned short* col,
                                           int shift, const uint2* tab,
                                           const unsigned* winc, int i,
                                           int lane, int& step, int& nm_add) {
  int chain = 0, mis = 0, near = 0;  // near: those of the first 127 rows
  for (int top = i;; top -= 32) {
    const int row = top - lane;
    bool on = false, mm = false;
    if (row >= 0) {
      on = ((col[row] >> shift) & 3) == 1;
      const unsigned qcls = tab[row].y >> 16;
      mm = qcls == 4 || qcls != (winc[row] & 15u);
    }
    const unsigned stop = __ballot_sync(FULL_MASK, !on);
    const int k = stop ? __ffs(stop) - 1 : 32;  // chain rows this round
    const unsigned mb =
        __ballot_sync(FULL_MASK, on && mm) & (k < 32 ? (1u << k) - 1 : ~0u);
    const int room = 127 - chain;  // rows of this round inside the jump
    mis += __popc(mb);
    near += __popc(room >= 32 ? mb : mb & ((1u << max(room, 0)) - 1));
    chain += k;
    if (stop) break;
  }
  step = min(chain, 127);
  nm_add = min(mis, 127) - min(mis - near, 127);
}

// One warp per alignment, lane l owns band columns 4l .. 4l+3.  out rows
// (stride out_stride): score, qbeg, qend, rbeg, rend, gscore, grend, n_ops,
// nm; ops/lens (n, max_ops) in alignment order, 0 past n_ops.
template <bool LUT>
__global__ void __launch_bounds__(CIGAR_WARPS * 32)
sw_cigar_kernel(const int* __restrict__ query, const int* __restrict__ qlens,
                const int* __restrict__ ref, int n_lanes, int Lq, int Lr,
                int p_match, int p_mis, int p_open, int p_ext, int max_ops,
                int* __restrict__ out, long out_stride,
                int* __restrict__ ops_out, int* __restrict__ lens_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * CIGAR_WARPS + w;
  if (n >= n_lanes) return;  // warp-uniform
  const int qlen = qlens[n];
  // a dead lane (qlen < 1) is row 0 with H = 0 and no moves
  int score = 0, qbeg = 1, qend = 1, rbeg = 1, rend = 1, gscore = 0;
  int grend = Lr, nops = 0, nm = 0;
  unsigned slot0 = 0, slot1 = 0;  // op buffer: slots l and l + 32, op | len << 2
  if (qlen >= 1 && Lq > 0) {
    const int P = code_pitch(Lq);
    unsigned char* base = smem + w * cigar_warp_bytes(Lq);
    unsigned* win = reinterpret_cast<unsigned*>(base);
    uint2* tab = reinterpret_cast<uint2*>(base + 4 * WIN_COLS);
    unsigned short* codes = reinterpret_cast<unsigned short*>(
        base + 4 * WIN_COLS + 16 * ((Lq + 2) / 2));
    stage<LUT, true>(win, tab, query + (long)n * Lq, ref + (long)n * Lr,
                     Lq, Lr, p_match, p_mis, lane);
    __syncwarp();

    const int c0 = lane * 4;
    const ScoreConst k = make_const(Lq, Lr, p_match, p_mis, p_open, p_ext, c0);
    // PenFill's fills: lanes below 1, 2, 3, 4 and 16
    const int pen[5] = {lane < 1 ? FILL_PEN : 0, lane < 2 ? FILL_PEN : 0,
                        lane < 3 ? FILL_PEN : 0, lane < 4 ? FILL_PEN : 0,
                        lane < 16 ? FILL_PEN : 0};
    // bk[t] = max over rows of H * K + R_i, R_i = K - 1 - i (Lr + 1): the
    // key (H (Lq+1) + Lq - i) Lr + Lr - 1 - (i + c) plus c
    int H[4] = {0, 0, 0, 0}, V[4] = {NEG, NEG, NEG, NEG}, bk[4] = {0, 0, 0, 0};
    int R = k.K - 1;
    const int rows = min(qlen, Lq);
    unsigned short* mine = codes + lane * P;
    uint4 cur = *reinterpret_cast<const uint4*>(win + c0);
    uint2 t0 = tab[0];
    for (int i0 = 0; i0 < rows; i0 += 4, mine += 4) {
      const uint4 nx = *reinterpret_cast<const uint4*>(win + i0 + 4 + c0);
      const unsigned cat[8] = {cur.x, cur.y, cur.z, cur.w,
                               nx.x, nx.y, nx.z, nx.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s > 0 && i0 + s >= rows) break;  // warp-uniform
        const uint2 t1 = tab[i0 + s + 1];
        const unsigned wv[4] = {cat[s], cat[s + 1], cat[s + 2], cat[s + 3]};
        mine[s] = (unsigned short)cigar_row<LUT>(H, V, bk, R, t0, wv, k,
                                                 pen, lane);
        t0 = t1;
      }
      cur = nx;
    }
    int b = max(max(bk[0] - c0, bk[1] - c0 - 1), max(bk[2] - c0 - 2,
                                                     bk[3] - c0 - 3));
    int g = 0;
    if (qlen <= Lq) {  // H is row qlen - 1
#pragma unroll
      for (int t = 0; t < 4; ++t)
        g = max(g, H[t] * Lr + (Lr - qlen - c0 - t));
    }
    // both keys are >= 0, so C division matches the twin's floor division
    b = __reduce_max_sync(FULL_MASK, b);
    g = __reduce_max_sync(FULL_MASK, g);
    const int M = (Lq + 1) * Lr;
    score = b / M;
    qend = Lq - (b % M) / Lr + 1;
    rend = Lr - (b % M) % Lr;
    gscore = g / Lr;
    grend = Lr - g % Lr;
    __syncwarp();  // every lane's codes are visible to the walk

    // ---- the walk, the same in every lane: (i, j) in global coordinates
    // from the best cell; forced I/D extension modes read the code at the
    // clamped cell, as the twin does
    int i = qend - 1, j = rend - 1, mode = 0, kop = 0, cur_op = -1;
    int cur_len = 0;
    const int limit = Lq + Lr;
    for (int steps = 0; steps < limit; ++steps) {
      const int c = j - i;
      const int ii = min(max(i, 0), Lq - 1);
      const int cc = min(max(c, 0), BAND - 1);
      // the cell's move | I-extend << 2 | D-extend << 3
      const unsigned word = codes[(cc >> 2) * P + ii];
      const int p = (word >> (3 * (cc & 3)) & 7) |
                    (word >> (9 + (cc & 3)) & 8);
      const bool oob = i < 0 || j < 0 || c < 0 || c >= BAND;
      const int de = mode == 1 ? 2 : (mode == 2 ? 3 : (oob ? 0 : (p & 3)));
      const bool fin = de == 0;
      const int op = de == 1 ? 0 : (de == 2 ? 1 : 2);
      int step = 1, nm_add = 1;
      if (de == 1)
        diag_chain(codes + (c >> 2) * P, 3 * (c & 3), tab, win + c, i, lane,
                   step, nm_add);
      const bool change = !fin && cur_len > 0 && op != cur_op;
      if (change || (fin && cur_len > 0)) {
        const int kf = min(kop, max_ops - 1);  // overflow: the last slot
        const unsigned v = (unsigned)cur_op | (unsigned)cur_len << 2;
        if ((kf & 31) == lane) {
          if (kf < 32) slot0 = v;
          else slot1 = v;
        }
        ++kop;
      }
      if (fin) break;
      cur_len = change ? step : cur_len + step;
      cur_op = op;
      nm += nm_add;
      if (de == 1) { i -= step; j -= step; }
      else if (de == 2) { i -= 1; }
      else { j -= 1; }
      mode = (de == 2 && (p & 4)) ? 1 : ((de == 3 && (p & 8)) ? 2 : 0);
    }
    nops = min(kop, max_ops);
    qbeg = i + 1;
    rbeg = j + 1;
  }
  // the walk ran end -> start: position t takes slot nops - 1 - t
  const int s0 = nops - 1 - lane, s1 = nops - 33 - lane;  // s1 < 32
  const unsigned a0 = __shfl_sync(FULL_MASK, slot0, s0 & 31);
  const unsigned a1 = __shfl_sync(FULL_MASK, slot1, s0 & 31);
  const unsigned b0 = __shfl_sync(FULL_MASK, slot0, s1 & 31);
  const unsigned v0 = s0 < 0 ? 0u : (s0 < 32 ? a0 : a1);
  const unsigned v1 = s1 < 0 ? 0u : b0;
  int* po = ops_out + (long)n * max_ops;
  int* pl = lens_out + (long)n * max_ops;
  if (lane < max_ops) { po[lane] = v0 & 3; pl[lane] = v0 >> 2; }
  if (lane + 32 < max_ops) { po[lane + 32] = v1 & 3; pl[lane + 32] = v1 >> 2; }
  if (lane == 0) {
    out[0 * out_stride + n] = score;
    out[1 * out_stride + n] = qbeg;
    out[2 * out_stride + n] = qend;
    out[3 * out_stride + n] = rbeg;
    out[4 * out_stride + n] = rend;
    out[5 * out_stride + n] = gscore;
    out[6 * out_stride + n] = grend;
    out[7 * out_stride + n] = nops;
    out[8 * out_stride + n] = nm;
  }
}

template <bool LUT>
int launch_cigar(const void* query, const void* qlen, const void* ref, int n,
                 int Lq, int Lr, int p_match, int p_mis, int p_open,
                 int p_ext, int max_ops, void* out, long out_stride,
                 void* ops, void* lens, cudaStream_t stream) {
  const int smem = CIGAR_WARPS * cigar_warp_bytes(Lq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_cigar_kernel<LUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + CIGAR_WARPS - 1) / CIGAR_WARPS));
  sw_cigar_kernel<LUT><<<grid, CIGAR_WARPS * 32, smem, stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr,
      p_match, p_mis, p_open, p_ext, max_ops, (int*)out, out_stride,
      (int*)ops, (int*)lens);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous int32 arrays:
// query (n, Lq), qlen (n,), ref (n, Lr), out (9, out_stride),
// ops/lens (n, max_ops).  Returns cudaGetLastError() after the launch.
int ssq_sw_cigar(const void* query, const void* qlen, const void* ref, int n,
                 int Lq, int Lr, int p_match, int p_mis, int p_open, int p_ext,
                 int max_ops, void* out, long out_stride, void* ops,
                 void* lens, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr > MAX_LR || max_ops < 1 ||
      max_ops > MAX_OPS_CAP)
    return (int)cudaErrorInvalidValue;
  // the int8 table holds p_match, -p_mis and -1
  const bool lut = p_match >= -128 && p_match <= 127 && p_mis >= -127 &&
                   p_mis <= 128;
  return (lut ? launch_cigar<true> : launch_cigar<false>)(
      query, qlen, ref, n, Lq, Lr, p_match, p_mis, p_open, p_ext, max_ops,
      out, out_stride, ops, lens, (cudaStream_t)stream);
}

// Dynamic shared bytes a block of the cigar kernel takes at this Lq.
int ssq_sw_cigar_smem(int Lq) { return CIGAR_WARPS * cigar_warp_bytes(Lq); }

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
