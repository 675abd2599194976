// Unbanded local affine-gap Smith-Waterman, score only, for Hopper
// (sm_90a), behind a plain C interface for ctypes.
//
// Replaces the XLA lax.scan of speedseq_tpu/align/sw.py:banded_sw_score
// (var's and somatic's haplotype scan: every read of a window against each
// candidate haplotype's window, one call a window), which the port ran as
// a Python loop of ~22 small launches a query row.  It computes exactly
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
// Design: one warp per alignment (one-warp blocks, so a few hundred lanes
// spread over every SM).  Thread t holds C = ceil(Lr / 32) contiguous
// columns [t*C, t*C + C) of the H and V rows and its window codes in
// registers (C a template parameter, rounded up to the next instantiated
// width).  A row: the query code comes by one shuffle from a register
// refilled every 32 rows; the diagonal neighbour of a thread's first
// column by one __shfl_up_sync of the left thread's last H; each thread's
// serial max of Ht + e*j, then a 5-step shuffle scan of the thread maxima,
// gives the exclusive prefix max; the row max is one __reduce_max_sync,
// and only on a row that moves the best cell or ends the read does a
// ballot find its first column.
//
// What bounds it on this card: int32 instructions, 8 a cell
// (ops/sw_unbanded.py:OPS_PER_CELL), against 132 SMs x 128 lanes x clock;
// a call reads (Lq + Lr + 1) x 4 bytes and writes 20 bytes an alignment.
// At var's ~280 lanes a call the instruction bound is a few microseconds
// and one row's dependent chain (the H shuffle, the serial max, six scan
// shuffles, the reduction) sets the pace instead: only more lanes a call,
// or one alignment across several warps, would pass it.

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

}  // extern "C"
