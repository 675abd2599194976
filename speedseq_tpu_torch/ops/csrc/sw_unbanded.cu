// Unbanded local affine-gap Smith-Waterman for Hopper (sm_90a), behind a
// plain C interface for ctypes: the score-only scan in two widths and the
// DP with traceback.
//
// ssq_sw_unbanded_score / ssq_sw_unbanded_score_wide replace the XLA
// lax.scan of speedseq_tpu/align/sw.py:banded_sw_score (var's and
// somatic's haplotype scan: every read of a window against each
// candidate haplotype's window, one call a window), which the port ran as
// a Python loop of ~22 small launches a query row.  They compute exactly
// what that scan computes (bit-equal outputs; the plain PyTorch twin
// ops/sw_unbanded.py:sw_score_unbanded_plain is the executable
// specification):
//   - no band: every (row, column) cell of the Lq x Lr matrix;
//   - sub(q, r) = match / -mismatch when both codes are < 4 (a negative
//     code too: equal negative codes score a match), else -1;
//   - the deletion state is the exclusive prefix max of Ht + e*j over the
//     whole row (no 64-column cap: that is the Pallas kernels');
//   - the best cell moves only on a strictly larger row max, and takes the
//     row's first maximal column; gscore/grend are row qlen - 1's; rows at
//     or past qlen change nothing, so the loop stops there.
//
// Design of the narrow scan (Lr <= 1024): one warp per alignment
// (one-warp blocks, so a few hundred lanes spread over every SM).  Thread
// t holds C = ceil(Lr / 32) contiguous columns [t*C, t*C + C) of the H and
// V rows and its window codes in registers (C a template parameter,
// rounded up to the next instantiated width).  A row: the query code comes
// by one shuffle from a register refilled every 32 rows; the diagonal
// neighbour of a thread's first column by one __shfl_up_sync of the left
// thread's last H; each thread's serial max of Ht + e*j, then a 5-step
// shuffle scan of the thread maxima, gives the exclusive prefix max; the
// row max is one __reduce_max_sync, and only on a row that moves the best
// cell or ends the read does a ballot find its first column.
//
// The wide scan (Lr > 1024) keeps the row (H, V and the window codes, 12
// bytes a column) in shared memory, or in a device-memory scratch the
// wrapper allocates where a block cannot hold it, and walks each row in
// tiles of T = 32 * C columns (C in 20, 24, 32: the narrow layout, one
// tile at a time, loaded into registers and stored back).  From tile to
// tile, in column order, it carries the exclusive prefix max of Ht + e*j,
// the previous row's H left of the tile (the diagonal neighbour of the
// tile's first column: kept before the tile is overwritten), and the row
// max with its first column (a later tile replaces it only when strictly
// larger); V lives with the row.
//
// What bounds the scan on this card: int32 instructions, 8 a cell
// (ops/sw_unbanded.py:OPS_PER_CELL), against 132 SMs x 128 lanes x clock;
// a call reads (Lq + Lr + 1) x 4 bytes and writes 20 bytes an alignment.
// At var's ~280 lanes a call the instruction bound is a few microseconds
// and one row's dependent chain (the H shuffle, the serial max, six scan
// shuffles, the reduction) sets the pace instead: only more lanes a call,
// or one alignment across several warps, would pass it.  The wide scan
// adds a shared-memory load and store of H and V a cell.
//
// ssq_sw_unbanded_cigar replaces the XLA lax.scan + fori_loop traceback of
// speedseq_tpu/align/sw.py:banded_sw (the unfused alignment API's
// extension, align_candidates), with the plain twin
// ops/sw_unbanded.py:sw_cigar_unbanded_plain as its specification: the
// same DP (Lr <= 256), then the affine traceback state machine of
// banded_sw's tb_body (mode 1 inside an I-run forces a vertical step,
// a deletion run is jumped to the arg of the exclusive prefix max of the
// value-major key (Ht + e*j) * Lr + j, so a tie takes the largest column;
// past max_ops ops the last slot is overwritten while its length keeps
// adding and n_ops keeps counting).  One warp an alignment, 8 columns a
// thread.  A cell leaves a 4-bit code in shared memory (a thread's 8
// columns are one 32-bit word a row, 128 bytes a row, 19,200 bytes at Lq
// 150, so 11 blocks an SM; nothing in device memory): the direction (0
// stop, 1 diag, 2 I, 3 D; ties diag > I > D; 0 where H <= 0), the
// vertical-extend bit, and a record bit set where the cell's key exceeds
// every key left of it: the deletion source of column j is the last
// record column before j, so the walk finds it by one ballot over the
// row's words instead of a stored distance.  The row (cigar_row) is built
// for few instructions, since the forward pass holds the kernel (the walk
// is a few per cent of its time, measured by cutting it out): the prefix
// max runs on values, the direction and the record bit are sign
// bits, the max-of-sum steps are DPX instructions, one reduction of
// h * 256 + 255 - j gives the row max and its first column, and the cells
// past the window need no mask.  The walk, every thread of the warp in
// step, takes a plain diagonal run whole (32 cells (i - t, j - t) a
// ballot) and keeps the cigar in registers: the op being written, and the
// finished ops in their slots' threads (slots t and t + 32), shuffled out
// reversed at the end.  Its bound: int32 instructions, ops/sw_unbanded.py:
// OPS_PER_CELL_CIGAR a cell, or its bytes (queries, windows and the ten
// outputs); the walk is Lq + Lr steps at most.

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -1000000;
constexpr int MAX_LR = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Scoring {
  int match, mis, open, ext;
};

template <int C>
__global__ void __launch_bounds__(32)
    sw_unbanded_kernel(const int* __restrict__ query,
                       const int* __restrict__ qlen,
                       const int* __restrict__ ref, int n, int Lq, int Lr,
                       Scoring p, int* __restrict__ out, long stride) {
  const int lane = blockIdx.x;
  if (lane >= n) return;
  const int t = threadIdx.x;
  const int j0 = t * C;
  const int* q = query + (long)lane * Lq;
  const int* r = ref + (long)lane * Lr;
  int rc[C], H[C], V[C], Ht[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    rc[k] = j0 + k < Lr ? r[j0 + k] : 4;
    H[k] = 0;
    V[k] = NEG;
  }
  const int ql = qlen[lane];
  const int rows = min(ql, Lq);
  const int oe = p.open + p.ext;
  int bs = 0, bq = 0, br = 0, gs = 0, gr = 0;
  int qreg = 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) qreg = i + t < Lq ? q[i + t] : 4;
    const int qc = __shfl_sync(FULL, qreg, i & 31);
    const bool q_ok = qc < 4;
    int left = __shfl_up_sync(FULL, H[C - 1], 1);
    if (t == 0) left = 0;
    // Ht, V and this thread's running max of Ht + e*j
    int run = NEG;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int sub = (q_ok && rc[k] < 4) ? (qc == rc[k] ? p.match : -p.mis)
                                          : -1;
      const int diag = sub + (k ? H[k - 1] : left);
      const int vr = max(V[k] - p.ext, H[k] - oe);
      V[k] = vr;
      Ht[k] = j0 + k < Lr ? max(max(diag, vr), 0) : 0;
      run = max(run, Ht[k] + p.ext * (j0 + k));
    }
    // exclusive prefix max of the thread maxima
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (t >= d) incl = max(incl, y);
    }
    int pm = __shfl_up_sync(FULL, incl, 1);
    if (t == 0) pm = NEG;
    // H = max(Ht, F), and this thread's first maximal column
    int tb = -1, tj = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const int h = j < Lr ? max(Ht[k], pm - p.open - p.ext * j) : 0;
      pm = max(pm, Ht[k] + p.ext * j);
      H[k] = h;
      if (h > tb) {
        tb = h;
        tj = j;
      }
    }
    const int rowmax = __reduce_max_sync(FULL, tb);
    const bool last = i == ql - 1;
    if (rowmax > bs || last) {
      // threads hold ascending columns: the lowest thread holding the max
      // holds its first column
      const unsigned hold = __ballot_sync(FULL, tb == rowmax);
      const int rj = __shfl_sync(FULL, tj, __ffs(hold) - 1) + 1;
      if (rowmax > bs) {
        bs = rowmax;
        bq = i + 1;
        br = rj;
      }
      if (last) {
        gs = rowmax;
        gr = rj;
      }
    }
  }
  if (t == 0) {
    out[lane] = bs;
    out[stride + lane] = bq;
    out[2 * stride + lane] = br;
    out[3 * stride + lane] = gs;
    out[4 * stride + lane] = gr;
  }
}

template <int C>
int launch(const void* query, const void* qlen, const void* ref, int n,
           int Lq, int Lr, Scoring p, void* out, long stride,
           cudaStream_t stream) {
  sw_unbanded_kernel<C><<<n, 32, 0, stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr, p,
      (int*)out, stride);
  return (int)cudaGetLastError();
}


// ---- the wide scan: Lr > 1024, the row in shared or device memory ------

constexpr int WIDE_BYTES_PER_COL = 12;   // H, V and the window code, int32

template <int C>
__global__ void __launch_bounds__(32)
    sw_unbanded_wide_kernel(const int* __restrict__ query,
                            const int* __restrict__ qlen,
                            const int* __restrict__ ref, int n, int Lq,
                            int Lr, int ntiles, Scoring p,
                            int* __restrict__ out, long stride,
                            unsigned char* __restrict__ scratch) {
  constexpr int T = 32 * C;
  extern __shared__ int4 wide_smem[];
  const int lane = blockIdx.x;
  if (lane >= n) return;
  const int t = threadIdx.x;
  const long Lp = (long)ntiles * T;
  // column j = tile*T + t*C + k lives at tile*T + k*32 + t: each thread
  // touches only its own slots, and a warp's accesses are consecutive
  int* Hrow = scratch ? (int*)(scratch + (long)lane * Lp * WIDE_BYTES_PER_COL)
                      : (int*)wide_smem;
  int* Vrow = Hrow + Lp;
  int* Rrow = Vrow + Lp;
  const int* q = query + (long)lane * Lq;
  const int* r = ref + (long)lane * Lr;
  for (int tile = 0; tile < ntiles; ++tile) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const long s = (long)tile * T + k * 32 + t;
      const int j = tile * T + t * C + k;
      Hrow[s] = 0;
      Vrow[s] = NEG;
      Rrow[s] = j < Lr ? r[j] : 4;
    }
  }
  const int ql = qlen[lane];
  const int rows = min(ql, Lq);
  const int oe = p.open + p.ext;
  int bs = 0, bq = 0, br = 0, gs = 0, gr = 0;
  int qreg = 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) qreg = i + t < Lq ? q[i + t] : 4;
    const int qc = __shfl_sync(FULL, qreg, i & 31);
    const bool q_ok = qc < 4;
    int hdiag = 0;     // the previous row's H left of the tile
    int pmc = NEG;     // max of Ht + e*j over the row's earlier tiles
    int rb = -1, rj = 0;   // the row's max so far and its first column
    for (int tile = 0; tile < ntiles; ++tile) {
      const int j0 = tile * T + t * C;
      int* Hs = Hrow + (long)tile * T + t;
      int* Vs = Vrow + (long)tile * T + t;
      const int* Rs = Rrow + (long)tile * T + t;
      int H[C], V[C], Ht[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        H[k] = Hs[k * 32];
        V[k] = Vs[k * 32];
      }
      int left = __shfl_up_sync(FULL, H[C - 1], 1);
      if (t == 0) left = hdiag;
      hdiag = __shfl_sync(FULL, H[C - 1], 31);
      int run = NEG;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int rc = Rs[k * 32];
        const int sub = (q_ok && rc < 4) ? (qc == rc ? p.match : -p.mis) : -1;
        const int diag = sub + (k ? H[k - 1] : left);
        const int vr = max(V[k] - p.ext, H[k] - oe);
        V[k] = vr;
        Ht[k] = j0 + k < Lr ? max(max(diag, vr), 0) : 0;
        run = max(run, Ht[k] + p.ext * (j0 + k));
      }
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (t >= d) incl = max(incl, y);
      }
      int pm = __shfl_up_sync(FULL, incl, 1);
      pm = t == 0 ? pmc : max(pm, pmc);
      pmc = max(pmc, __shfl_sync(FULL, incl, 31));
      int tb = -1, tj = 0;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = j0 + k;
        const int h = j < Lr ? max(Ht[k], pm - p.open - p.ext * j) : 0;
        pm = max(pm, Ht[k] + p.ext * j);
        Hs[k * 32] = h;
        Vs[k * 32] = V[k];
        if (h > tb) {
          tb = h;
          tj = j;
        }
      }
      const int tmax = __reduce_max_sync(FULL, tb);
      if (tmax > rb) {   // a later tile takes the row max only when larger
        const unsigned hold = __ballot_sync(FULL, tb == tmax);
        rj = __shfl_sync(FULL, tj, __ffs(hold) - 1);
        rb = tmax;
      }
    }
    if (rb > bs) {
      bs = rb;
      bq = i + 1;
      br = rj + 1;
    }
    if (i == ql - 1) {
      gs = rb;
      gr = rj + 1;
    }
  }
  if (t == 0) {
    out[lane] = bs;
    out[stride + lane] = bq;
    out[2 * stride + lane] = br;
    out[3 * stride + lane] = gs;
    out[4 * stride + lane] = gr;
  }
}

template <int C>
int launch_wide(const void* query, const void* qlen, const void* ref, int n,
                int Lq, int Lr, int ntiles, Scoring p, void* out, long stride,
                void* scratch, cudaStream_t stream) {
  size_t smem = 0;
  if (!scratch) {
    smem = (size_t)ntiles * 32 * C * WIDE_BYTES_PER_COL;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          sw_unbanded_wide_kernel<C>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  sw_unbanded_wide_kernel<C><<<n, 32, smem, stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr,
      ntiles, p, (int*)out, stride, (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

// ---- DP with traceback: banded_sw's contract, Lr <= 256 -----------------

constexpr int CIG_C = 8;          // columns a thread
constexpr int CIG_MAX_LR = 32 * CIG_C;
constexpr int CIG_MAX_OPS = 64;
constexpr int CIG_MAX_LQ = 1792;  // 128 bytes of codes a row, shared

// where row i's word w (columns 8w .. 8w + 7) lies in the code table:
// rotated by the row, so that the walk's 32 diagonal cells (i - t, j - t)
// fall in 32 banks but at most a few pairs
__device__ __forceinline__ int cslot(int i, int w) {
  return i * 32 + ((w + i) & 31);
}

// A thread's per-column constants of the traceback DP (j = 8t + k): the
// window code (4 where it is 4 or more: no query code below 4 equals
// it), the mismatch score (-1 at such a code; OFF_WINDOW past the window)
// and e j.
constexpr int OFF_WINDOW = -(1 << 20);
struct CigCols {
  int rk[CIG_C], mis[CIG_C], ej[CIG_C];
};

// One row of the traceback DP for a thread's 8 columns: updates H and V,
// returns the row's 32-bit word of 4-bit codes (column k in bits 4k ..
// 4k + 3: the direction's two bits, the vertical-extend bit, the record
// bit) and leaves in P the thread's max of h * 256 + 255 - j (the row max
// and its first column).
//   - the deletion state is the exclusive prefix max vmax of x = Ht + e j
//     over the row (a max tree within the thread for the scan, a 5-step
//     shuffle scan of the thread maxima, then a serial max), and h + e j
//     = max(x, vmax - o);
//   - the record bit: x >= vmax (the key (Ht + e j) * Lr + j of the twin
//     beats every key left of it, ties going to the larger column), so a
//     deletion's source is the last record column before it;
//   - no compare decides the direction: with X = diag - h, Y = V - h and
//     Z = -h (X, Y <= 0 <= h), bit 0 is the sign of Z & (Y | ~X) (diagonal
//     or deletion) and bit 1 the sign of Z & X (a gap), so ties go diag >
//     I > D and h <= 0 stops; the vertical-extend bit is the sign of
//     Hprev - Vprev - o - 1; each enters its nibble by one funnel shift,
//     and the nibbles join in a tree (a chain of 32 shifts is too long);
//   - the cells past the window (j >= Lr) run on unmasked, their diagonal
//     step scoring OFF_WINDOW: their values then come from real cells
//     through gaps only, so with o, e >= 0 each stays at or below the row
//     max of the real cells (a real cell of the row is at least the gap's
//     source less its vertical gap), and a tie goes to the real column in
//     P; no real cell reads them and the walk never reaches them;
//   - the max-of-sum steps are Hopper's DPX instructions (__viaddmax_s32:
//     max(a + b, c); its _relu form also takes 0).
template <bool QOK>
__device__ __forceinline__ unsigned cigar_row(int (&H)[CIG_C],
                                              int (&V)[CIG_C], int qc, int t,
                                              const CigCols& c, Scoring p,
                                              int& P) {
  int left = __shfl_up_sync(FULL, H[CIG_C - 1], 1);
  if (t == 0) left = 0;
  int Hd[CIG_C], sub[CIG_C], vx[CIG_C], vv[CIG_C], x[CIG_C];
#pragma unroll
  for (int k = 0; k < CIG_C; ++k) {
    Hd[k] = k ? H[k - 1] : left;
    sub[k] = QOK ? (qc == c.rk[k] ? p.match : c.mis[k])
                 : (c.mis[k] == OFF_WINDOW ? OFF_WINDOW : -1);
    vx[k] = H[k] - V[k] - (p.open + 1);
    vv[k] = __viaddmax_s32(V[k], -p.ext, H[k] - (p.open + p.ext));
    x[k] = __viaddmax_s32_relu(Hd[k], sub[k], vv[k]) + c.ej[k];
    V[k] = vv[k];
  }
  // this thread's max of x, then the exclusive prefix max over threads
  int incl = max(__vimax3_s32(x[0], x[1], x[2]),
                 __vimax3_s32(__vimax3_s32(x[3], x[4], x[5]), x[6], x[7]));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)   // shfl_up gives a lane below d its own
    incl = max(incl, __shfl_up_sync(FULL, incl, d));
  int vmax = __shfl_up_sync(FULL, incl, 1);
  if (t == 0) vmax = NEG;
  const int cbase = 255 - CIG_C * t;
  int rec[CIG_C], b0[CIG_C], b1[CIG_C];
  P = -(1 << 30);
#pragma unroll
  for (int k = 0; k < CIG_C; ++k) {
    const int h = __viaddmax_s32(vmax, -p.open, x[k]) - c.ej[k];
    rec[k] = vmax - x[k] - 1;
    vmax = max(vmax, x[k]);
    const int X = Hd[k] + sub[k] - h, Y = vv[k] - h, Z = -h;
    b0[k] = Z & (Y | ~X);
    b1[k] = Z & X;
    P = __viaddmax_s32(h * 256 + cbase, -k, P);
    H[k] = h;
  }
  // each column's nibble from its four sign bits, then the nibbles
  // joined in a tree (no carries: they do not overlap)
  unsigned nib[CIG_C];
#pragma unroll
  for (int k = 0; k < CIG_C; ++k) {
    nib[k] = (unsigned)rec[k] >> 31;
    nib[k] = __funnelshift_l((unsigned)vx[k], nib[k], 1);
    nib[k] = __funnelshift_l((unsigned)b1[k], nib[k], 1);
    nib[k] = __funnelshift_l((unsigned)b0[k], nib[k], 1);
  }
#pragma unroll
  for (int k = 0; k < CIG_C; k += 2) nib[k] += nib[k + 1] << 4;
#pragma unroll
  for (int k = 0; k < CIG_C; k += 4) nib[k] += nib[k + 2] << 8;
  return nib[0] + (nib[4] << 16);
}

__global__ void __launch_bounds__(32)
    sw_unbanded_cigar_kernel(const int* __restrict__ query,
                             const int* __restrict__ qlen,
                             const int* __restrict__ ref, int n, int Lq,
                             int Lr, Scoring p, int max_ops,
                             int* __restrict__ out, long stride,
                             signed char* __restrict__ ops_out,
                             int* __restrict__ lens_out) {
  // codes[cslot(i, t)]: nibble k = column 8t + k of row i; a nibble is
  // dir (2 bits) | vext << 2 | record << 3
  extern __shared__ unsigned codes[];
  const int lane = blockIdx.x;
  if (lane >= n) return;
  const int t = threadIdx.x;
  const int j0 = t * CIG_C;
  const int* q = query + (long)lane * Lq;
  const int* r = ref + (long)lane * Lr;
  CigCols c;
  int H[CIG_C], V[CIG_C];
#pragma unroll
  for (int k = 0; k < CIG_C; ++k) {
    const int j = j0 + k;
    const int rc = j < Lr ? r[j] : 4;
    c.rk[k] = rc < 4 ? rc : 4;
    c.mis[k] = j >= Lr ? OFF_WINDOW : rc < 4 ? -p.mis : -1;
    c.ej[k] = p.ext * j;
    H[k] = 0;
    V[k] = NEG;
  }
  const int ql = qlen[lane];
  const int rows = max(0, min(ql, Lq));
  int bs = 0, bi = 0, bj = 0, gs = 0, gj = 0;
  // the query's codes, 32 rows a register, the next 32 loaded a block
  // of rows ahead
  int qreg = t < Lq ? q[t] : 4, qnext = 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) {
      if (i > 0) qreg = qnext;
      qnext = i + 32 + t < Lq ? q[i + 32 + t] : 4;
    }
    const int qc = __shfl_sync(FULL, qreg, i & 31);
    int P;
    // a row whose query code is 4 or more scores -1 at every column
    const unsigned word = qc < 4 ? cigar_row<true>(H, V, qc, t, c, p, P)
                                 : cigar_row<false>(H, V, qc, t, c, p, P);
    codes[cslot(i, t)] = word;
    // the row max and its first column (threads hold ascending columns)
    P = __reduce_max_sync(FULL, P);
    const int rowmax = P >> 8, rj = 255 - (P & 255);
    if (rowmax > bs) {
      bs = rowmax;
      bi = i;
      bj = rj;
    }
    if (i == rows - 1) {
      gs = rowmax;
      gj = rj;
    }
  }
  __syncwarp();
  // the walk, every thread in step: tb_body of banded_sw.  A plain
  // diagonal run is taken whole: thread t reads cell (i - t, j - t), a
  // ballot finds the first that is no diagonal step (or lies out of
  // range), and the run goes into the M op at once; that cell, an
  // I step (mode 1 forces one) or a deletion jump is one step.  The
  // op being written stays in registers (cur_op, cur_len) and each
  // finished op goes to its slot's thread (slots t and t + 32).
  int i = bi, j = bj, mode = 0, kop = 0, last_op = -1;
  int cur_op = -1, cur_len = 0;
  int o0 = -1, o1 = -1, l0 = 0, l1 = 0;
  const auto flush = [&]() {   // the current op into slot kop - 1 (clipped)
    const int s = min(kop - 1, max_ops - 1);
    if (t == (s & 31)) {
      if (s < 32) {
        o0 = cur_op;
        l0 = cur_len;
      } else {
        o1 = cur_op;
        l1 = cur_len;
      }
    }
  };
  const auto emit = [&](int op, int len) {   // M 0, I 1, D 2; len steps
    if (kop > 0 && op == last_op) {
      cur_len += len;
      return;
    }
    // a new op takes slot min(kop, max_ops - 1): past max_ops - 1 the
    // last slot's op is overwritten and its length keeps adding
    if (kop >= max_ops) {
      cur_len += len;
    } else {
      if (kop > 0) flush();
      cur_len = len;
    }
    cur_op = op;
    last_op = op;
    ++kop;
  };
  if (bs > 0) {
    const int limit = Lq + Lr;   // banded_sw's steps
    int step = 0;
    while (step < limit) {
      unsigned code;
      int d;
      if (mode == 0) {
        if (i < 0 || j < 0) break;
        const int ri = i - t, cj = j - t;
        const unsigned cd =
            ri >= 0 && cj >= 0
                ? codes[cslot(ri, cj >> 3)] >> (4 * (cj & 7)) & 15u
                : 0u;
        const unsigned stop = __ballot_sync(FULL, (cd & 3u) != 1u);
        const int run = stop ? __ffs(stop) - 1 : 32;
        const int m = min(run, limit - step);
        if (m > 0) {
          emit(0, m);
          i -= m;
          j -= m;
          step += m;
        }
        if (m < run || run == 32) continue;
        code = __shfl_sync(FULL, cd, run);
        d = (int)(code & 3u);           // 0 also out of range
        if (d == 0) break;
      } else {
        const int ii = min(max(i, 0), Lq - 1), jj = min(max(j, 0), Lr - 1);
        code = codes[cslot(ii, jj >> 3)] >> (4 * (jj & 7));
        d = 2;
      }
      int step_len = 1;
      if (d == 3) {
        // the deletion source: the last record column of row i before j
        unsigned recs = codes[cslot(i, t)] & 0x88888888u;
        const int below = j - 8 * t;     // this word's columns before j
        if (below <= 0)
          recs = 0;
        else if (below < 8)
          recs &= (1u << (4 * below)) - 1u;
        const unsigned any = __ballot_sync(FULL, recs != 0);
        int gsrc = 0;
        if (any) {
          const int w = 31 - __clz(any);
          const unsigned rw = __shfl_sync(FULL, recs, w);
          gsrc = 8 * w + (31 - __clz(rw)) / 4;
        }
        step_len = max(min(max(j - gsrc, 0), 255), 1);
      }
      emit(d - 1, step_len);
      mode = (d == 2 && (code >> 2 & 1u)) ? 1 : 0;
      if (d == 2)
        --i;
      else
        j -= step_len;
      ++step;
    }
  }
  if (kop > 0) flush();
  // the ops were written end to start: reverse the valid prefix, each
  // slot from its thread
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = t + 32 * h;
    const int src = kop - 1 - x;
    const int s = max(min(src, max_ops - 1), 0);
    const int a0 = __shfl_sync(FULL, o0, s & 31);
    const int a1 = __shfl_sync(FULL, o1, s & 31);
    const int b0 = __shfl_sync(FULL, l0, s & 31);
    const int b1 = __shfl_sync(FULL, l1, s & 31);
    if (x < max_ops) {
      ops_out[(long)lane * max_ops + x] =
          (signed char)(src >= 0 ? (s < 32 ? a0 : a1) : -1);
      lens_out[(long)lane * max_ops + x] = src >= 0 ? (s < 32 ? b0 : b1) : 0;
    }
  }
  if (t == 0) {
    out[lane] = bs;
    out[stride + lane] = i + 1;
    out[2 * stride + lane] = bi + 1;
    out[3 * stride + lane] = j + 1;
    out[4 * stride + lane] = bj + 1;
    out[5 * stride + lane] = kop;
    out[6 * stride + lane] = gs;
    out[7 * stride + lane] = gj + 1;
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous int32 arrays: query
// (n, Lq), qlen (n,), ref (n, Lr), out (5, out_stride) = score, qend, rend,
// gscore, grend.  Needs 0 <= Lq <= Lr <= 1024, Lr >= 1.  Returns
// cudaGetLastError() after the launch.
int ssq_sw_unbanded_score(const void* query, const void* qlen,
                          const void* ref, int n, int Lq, int Lr, int p_match,
                          int p_mis, int p_open, int p_ext, void* out,
                          long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr < 1 || Lr > MAX_LR)
    return (int)cudaErrorInvalidValue;
  const Scoring p{p_match, p_mis, p_open, p_ext};
  const cudaStream_t s = (cudaStream_t)stream;
  const int need = (Lr + 31) / 32;
#define SSQ_UNBANDED(C)                                                  \
  if (need <= C)                                                         \
    return launch<C>(query, qlen, ref, n, Lq, Lr, p, out, out_stride, s);
  SSQ_UNBANDED(2)
  SSQ_UNBANDED(4)
  SSQ_UNBANDED(6)
  SSQ_UNBANDED(8)
  SSQ_UNBANDED(10)
  SSQ_UNBANDED(12)
  SSQ_UNBANDED(16)
  SSQ_UNBANDED(20)
  SSQ_UNBANDED(24)
  SSQ_UNBANDED(32)
#undef SSQ_UNBANDED
  return (int)cudaErrorInvalidValue;
}

// The wide scan (Lr > 1024), the same arrays and outputs as
// ssq_sw_unbanded_score; C (20, 24 or 32) and ntiles chosen by the wrapper
// with ntiles * 32 * C >= Lr.  scratch: NULL to keep the row in shared
// memory (ntiles * 32 * C * 12 bytes a block), else a device buffer of
// that many bytes a lane.  Needs 0 <= Lq <= Lr.
int ssq_sw_unbanded_score_wide(const void* query, const void* qlen,
                               const void* ref, int n, int Lq, int Lr,
                               int C, int ntiles, int p_match, int p_mis,
                               int p_open, int p_ext, void* out,
                               long out_stride, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr < 1 || ntiles < 1 ||
      (long)ntiles * 32 * C < Lr)
    return (int)cudaErrorInvalidValue;
  const Scoring p{p_match, p_mis, p_open, p_ext};
  const cudaStream_t s = (cudaStream_t)stream;
#define SSQ_WIDE(W)                                                        \
  if (C == W)                                                              \
    return launch_wide<W>(query, qlen, ref, n, Lq, Lr, ntiles, p, out,     \
                          out_stride, scratch, s);
  SSQ_WIDE(20)
  SSQ_WIDE(24)
  SSQ_WIDE(32)
#undef SSQ_WIDE
  return (int)cudaErrorInvalidValue;
}

// banded_sw's DP and traceback: query (n, Lq), qlen (n,), ref (n, Lr)
// int32; out (8, out_stride) int32 = score, qbeg, qend, rbeg, rend, n_ops,
// gscore, grend; ops (n, max_ops) int8 (-1 padding), lens (n, max_ops)
// int32 (0 padding).  Needs 1 <= Lq <= 1792, 1 <= Lr <= 256, 1 <= max_ops
// <= 64, and gap penalties open, ext >= 0.
int ssq_sw_unbanded_cigar(const void* query, const void* qlen,
                          const void* ref, int n, int Lq, int Lr, int p_match,
                          int p_mis, int p_open, int p_ext, int max_ops,
                          void* out, long out_stride, void* ops, void* lens,
                          void* stream) {
  if (n <= 0) return 0;
  if (Lq < 1 || Lq > CIG_MAX_LQ || Lr < 1 || Lr > CIG_MAX_LR ||
      max_ops < 1 || max_ops > CIG_MAX_OPS || p_open < 0 || p_ext < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Lq * 32 * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_unbanded_cigar_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_unbanded_cigar_kernel<<<n, 32, smem, (cudaStream_t)stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr,
      Scoring{p_match, p_mis, p_open, p_ext}, max_ops, (int*)out,
      out_stride, (signed char*)ops, (int*)lens);
  return (int)cudaGetLastError();
}

}  // extern "C"
