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
// 150; nothing in device memory): the direction (0 stop, 1 diag, 2 I, 3 D;
// ties diag > I > D; 0 where H <= 0), the vertical-extend bit, and a
// record bit set where the cell's key exceeds every key left of it: the
// deletion source of column j is the last record column before j, so the
// walk finds it by one ballot over the row's words instead of a stored
// distance.  Every thread of the warp runs the walk in step (its reads of
// the code table are broadcasts); thread 0 keeps the cigar's lengths in
// shared memory.  Its bound: int32 instructions, ops/sw_unbanded.py:
// OPS_PER_CELL_CIGAR a cell, or its bytes (queries, windows and the ten
// outputs); the walk is Lq + Lr steps at most and, like the scan's rows,
// a dependent chain.

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

__global__ void __launch_bounds__(32)
    sw_unbanded_cigar_kernel(const int* __restrict__ query,
                             const int* __restrict__ qlen,
                             const int* __restrict__ ref, int n, int Lq,
                             int Lr, Scoring p, int max_ops,
                             int* __restrict__ out, long stride,
                             signed char* __restrict__ ops_out,
                             int* __restrict__ lens_out) {
  // codes[i * 32 + t]: nibble k = column 8t + k of row i; a nibble is
  // dir (2 bits) | vext << 2 | record << 3
  extern __shared__ unsigned codes[];
  __shared__ int lens[CIG_MAX_OPS];
  __shared__ signed char ops[CIG_MAX_OPS];
  const int lane = blockIdx.x;
  if (lane >= n) return;
  const int t = threadIdx.x;
  const int j0 = t * CIG_C;
  const int* q = query + (long)lane * Lq;
  const int* r = ref + (long)lane * Lr;
  int rc[CIG_C], H[CIG_C], V[CIG_C];
#pragma unroll
  for (int k = 0; k < CIG_C; ++k) {
    rc[k] = j0 + k < Lr ? r[j0 + k] : 4;
    H[k] = 0;
    V[k] = NEG;
  }
  for (int x = t; x < max_ops; x += 32) {
    lens[x] = 0;
    ops[x] = -1;
  }
  const int ql = qlen[lane];
  const int rows = max(0, min(ql, Lq));
  const int oe = p.open + p.ext;
  int bs = 0, bi = 0, bj = 0, gs = 0, gj = 0;
  int qreg = 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) qreg = i + t < Lq ? q[i + t] : 4;
    const int qc = __shfl_sync(FULL, qreg, i & 31);
    const bool q_ok = qc < 4;
    int left = __shfl_up_sync(FULL, H[CIG_C - 1], 1);
    if (t == 0) left = 0;
    int Ht[CIG_C], dg[CIG_C], vv[CIG_C];
    unsigned vx = 0;
    int run = -1;      // this thread's max key (Ht + e*j) * 256 + j
#pragma unroll
    for (int k = 0; k < CIG_C; ++k) {
      const int j = j0 + k;
      const int sub = (q_ok && rc[k] < 4) ? (qc == rc[k] ? p.match : -p.mis)
                                          : -1;
      dg[k] = sub + (k ? H[k - 1] : left);
      const int ve = V[k] - p.ext, ho = H[k] - oe;
      vv[k] = max(ve, ho);
      vx |= (unsigned)(ve >= ho) << k;
      V[k] = vv[k];
      Ht[k] = j < Lr ? max(max(dg[k], vv[k]), 0) : 0;
      run = max(run, (Ht[k] + p.ext * j) * 256 + j);
    }
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (t >= d) incl = max(incl, y);
    }
    int pm = __shfl_up_sync(FULL, incl, 1);   // keys are >= 0; -1: none
    if (t == 0) pm = -1;
    unsigned word = 0;
    int tb = -1, tj = 0;
#pragma unroll
    for (int k = 0; k < CIG_C; ++k) {
      const int j = j0 + k;
      const int key = (Ht[k] + p.ext * j) * 256 + j;
      const int F = (pm >= 0 ? pm >> 8 : NEG) - p.open - p.ext * j;
      const int h = j < Lr ? max(Ht[k], F) : 0;
      const unsigned dir = (j >= Lr || h <= 0) ? 0u
                           : h == dg[k]        ? 1u
                           : h == vv[k]        ? 2u
                           : h == F            ? 3u
                                               : 0u;
      word |= (dir | ((vx >> k) & 1u) << 2 | (unsigned)(key > pm) << 3)
              << (4 * k);
      pm = max(pm, key);
      H[k] = h;
      if (h > tb) {
        tb = h;
        tj = j;
      }
    }
    codes[i * 32 + t] = word;
    const int rowmax = __reduce_max_sync(FULL, tb);
    const bool last = i == rows - 1;
    if (rowmax > bs || last) {
      const unsigned hold = __ballot_sync(FULL, tb == rowmax);
      const int rj = __shfl_sync(FULL, tj, __ffs(hold) - 1);
      if (rowmax > bs) {
        bs = rowmax;
        bi = i;
        bj = rj;
      }
      if (last) {
        gs = rowmax;
        gj = rj;
      }
    }
  }
  __syncwarp();
  // the walk, every thread in step: tb_body of banded_sw
  int i = bi, j = bj, mode = 0, kop = 0, last_op = -1;
  if (bs > 0) {
    for (int step = 0; step < Lq + Lr; ++step) {
      const bool oob = i < 0 || j < 0;
      const int ii = min(max(i, 0), Lq - 1), jj = min(max(j, 0), Lr - 1);
      const unsigned code = codes[ii * 32 + (jj >> 3)] >> (4 * (jj & 7));
      const int d = mode == 1 ? 2 : oob ? 0 : (int)(code & 3u);
      if (d == 0) break;
      int step_len = 1;
      if (d == 3) {
        // the deletion source: the last record column of row ii before jj
        unsigned recs = codes[ii * 32 + t] & 0x88888888u;
        const int below = jj - 8 * t;     // this word's columns before jj
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
        step_len = max(min(max(jj - gsrc, 0), 255), 1);
      }
      const int op = d - 1;            // M 0, I 1, D 2
      if (kop > 0 && op == last_op) {
        if (t == 0) lens[min(kop - 1, max_ops - 1)] += step_len;
      } else {
        const int w = min(kop, max_ops - 1);
        if (t == 0) {
          ops[w] = (signed char)op;
          lens[w] += step_len;
        }
        ++kop;
        last_op = op;
      }
      mode = (d == 2 && (code >> 2 & 1u)) ? 1 : 0;
      if (d == 1) {
        --i;
        --j;
      } else if (d == 2) {
        --i;
      } else {
        j -= step_len;
      }
    }
  }
  __syncwarp();
  // the ops were written end to start: reverse the valid prefix
  for (int x = t; x < max_ops; x += 32) {
    const int src = kop - 1 - x;
    const int s = min(src, max_ops - 1);
    ops_out[(long)lane * max_ops + x] = src >= 0 ? ops[s] : (signed char)-1;
    lens_out[(long)lane * max_ops + x] = src >= 0 ? lens[s] : 0;
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
// <= 64.
int ssq_sw_unbanded_cigar(const void* query, const void* qlen,
                          const void* ref, int n, int Lq, int Lr, int p_match,
                          int p_mis, int p_open, int p_ext, int max_ops,
                          void* out, long out_stride, void* ops, void* lens,
                          void* stream) {
  if (n <= 0) return 0;
  if (Lq < 1 || Lq > CIG_MAX_LQ || Lr < 1 || Lr > CIG_MAX_LR ||
      max_ops < 1 || max_ops > CIG_MAX_OPS)
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
