// Per-cluster log-sum of member probability curves (sv's curve
// combination), for Hopper (sm_90a), behind a plain C interface for ctypes.
//
// Replaces the segment_sum of member log curves in the JAX package's
// _combine_jit (speedseq_tpu/sv/device.py:100-120), which the port ran as
// a Python loop over member ranks (~10 launches a rank a side).  For each
// cluster c and column w < W, starting from 0.0f and adding member rank
// r = 0 .. size[c] - 1 in that order, with row = first[c] + r and
// rel = w - (start[row] - lo[c]):
//   logf(max(curve[row, clamp(rel, 0, D - 1)], 1e-12f))  if 0 <= rel < clen[row]
//   logf(1e-12f)                                            otherwise.
// That is the twin's order (ops/sv_combine.py:sv_combine_logsum_plain, row
// order within a cluster), so the sums are bit-equal to it on the card: the
// file is built without --use_fast_math (ops/nvcc_build.py:NVCC_FLAGS), so
// logf is the accurate one torch.log runs, each add is rounded on its own
// (__fadd_rn: no contraction), and the max propagates NaN as torch.maximum
// does (fmaxf would not).
//
// Design: the logs are split from the adds; the adds are never split.  A
// block of B threads takes a (cluster, tile of TW columns): its first
// warp (or first TW / 32 warps) are the adders, one thread a column, and
// the other P threads are producers, each with one column of the tile and
// U members of every chunk of K = U P / TW members.  A chunk's log values
// go into one of two shared buffers while the adders add the other
// buffer's K values in row order; one barrier a chunk swaps them.  The
// producers run a software pipeline, so that no load latency lies between
// two barriers: in the round that the adders take chunk ch, a producer
// stores chunk ch + 1's logs (from curve values loaded a round earlier),
// issues chunk ch + 2's curve loads (predicated on the cell lying inside
// its member's curve; from member starts and lengths loaded a round
// earlier) and issues chunk ch + 3's start and length loads.  A warp
// none of whose cells lies inside takes no log.  A member then costs the
// adders about one FADD latency.  The tile: 128 columns, B = 256 and
// chunks of 4 members where the grid's C x ceil(W / 128) blocks fill at
// least half the SMs (many clusters, as in an sv run); else the widest of
// 64, 32, 16 columns that does, or 8, with B = 1024 and 30 or 31 producer
// warps (one deep pile: W / 8 blocks a side, chunks of 496 members).  Two
// entries: first and sizes int32, or int64 as torch.bincount gives them.
//
// What bounds it on this card: at many small clusters, the logs (the
// accurate logf, ~20 instructions, at the cells inside a member's curve)
// or the bytes (those cells read once, not the curves' padding); at one
// deep pile, one column's chain of dependent adds (4 clocks a member) on
// each of W / 8 SMs, with the producers' instructions about even with it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

template <typename I, int TW, int B, int U>
__global__ void __launch_bounds__(B)
    combine_logsum_kernel(const I* __restrict__ first,
                          const I* __restrict__ sizes,
                          const int* __restrict__ lo,
                          const int* __restrict__ start,
                          const int* __restrict__ clen,
                          const float* __restrict__ curves, int D, int W,
                          float* __restrict__ acc) {
  constexpr int ADDW = TW < 32 ? 32 : TW;  // adder threads, whole warps
  constexpr int PW = (B - ADDW) / TW;      // members apart, one producer
  constexpr int K = U * PW;                // members a chunk
  static_assert((B - ADDW) % TW == 0, "producers cover whole tiles");
  __shared__ float logs[2][K][TW];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int f = (int)first[c], m = (int)sizes[c], lc = lo[c];
  const int nch = (m + K - 1) / K;
  const float eps = 1e-12f;
  const float log_eps = logf(eps);
  const bool adder = tid < ADDW;
  const int pt = tid - ADDW;               // a producer's index
  const int lw = adder ? tid : pt % TW, k0 = adder ? 0 : pt / TW;
  const int w = blockIdx.y * TW + lw;
  // a producer's pipeline: member starts and lengths of one chunk, curve
  // values (and whether each lies inside its member's curve) of the next
  int st[U], cl[U];
  float xv[U];
  bool in[U];
  const auto members = [&](int ch) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = ch * K + k0 + u * PW;
      st[u] = r < m ? start[f + r] : 0;
      cl[u] = r < m ? clen[f + r] : 0;     // past the cluster: none inside
    }
  };
  const auto values = [&](int ch) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rel = w - (st[u] - lc);
      in[u] = rel >= 0 && rel < cl[u];
      const long row = f + ch * K + k0 + u * PW;
      xv[u] = in[u] ? curves[row * D + min(rel, D - 1)] : 0.0f;
    }
  };
  const auto logs_of = [&](int ch) {
    float(*L)[TW] = logs[ch & 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = log_eps;
      if (__any_sync(0xffffffffu, in[u])) {
        const float x = xv[u];             // NaN stays NaN
        if (in[u]) v = logf(x != x ? x : fmaxf(x, eps));
      }
      L[k0 + u * PW][lw] = v;
    }
  };

  if (!adder && nch > 0) {
    members(0);
    values(0);
    logs_of(0);
    if (nch > 1) {
      members(1);
      values(1);
    }
    if (nch > 2) members(2);
  }
  float a = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    // chunk ch's logs are in; the adds of chunk ch - 1 are done
    __syncthreads();
    if (adder) {
      if (tid < TW) {
        const float* L = &logs[ch & 1][0][tid];
        const int n = min(K, m - ch * K);
        if (n == K) {
#pragma unroll 16
          for (int k = 0; k < K; ++k) a = __fadd_rn(a, L[k * TW]);
        } else {
          for (int k = 0; k < n; ++k) a = __fadd_rn(a, L[k * TW]);
        }
      }
    } else {
      if (ch + 1 < nch) logs_of(ch + 1);
      if (ch + 2 < nch) values(ch + 2);
      if (ch + 3 < nch) members(ch + 3);
    }
  }
  if (tid < TW && w < W) acc[(long)c * W + w] = a;
}

template <typename I, int TW, int B, int U>
int launch(const void* first, const void* sizes, const void* lo, int C,
           const void* start, const void* clen, const void* curves, int D,
           int W, void* acc, cudaStream_t stream) {
  const dim3 grid((unsigned)C, (unsigned)((W + TW - 1) / TW));
  combine_logsum_kernel<I, TW, B, U><<<grid, B, 0, stream>>>(
      (const I*)first, (const I*)sizes, (const int*)lo, (const int*)start,
      (const int*)clen, (const float*)curves, D, W, (float*)acc);
  return (int)cudaGetLastError();
}

// SMs of the current device, asked once a device
int sm_count() {
  static int cache[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 132;
  if (cache[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
    cache[dev] = n;
  }
  return cache[dev];
}

// The tile: the widest whose grid fills half the SMs, else 8 columns;
// first and sizes of type I.
template <typename I>
int combine(const void* first, const void* sizes, const void* lo, int C,
            const void* start, const void* clen, const void* curves, int D,
            int W, void* acc, void* stream) {
  if (C <= 0 || W <= 0) return 0;
  if (D < 1 || W > 65535 * 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long half = sm_count() / 2;
  const auto blocks = [&](int tw) { return (long)C * ((W + tw - 1) / tw); };
#define SSQ_TILE(TW, B)                                                   \
  if (TW == 8 || blocks(TW) >= half)                                      \
    return launch<I, TW, B, 4>(first, sizes, lo, C, start, clen, curves, \
                               D, W, acc, s);
  SSQ_TILE(128, 256)
  SSQ_TILE(64, 1024)
  SSQ_TILE(32, 1024)
  SSQ_TILE(16, 1024)
  SSQ_TILE(8, 1024)
#undef SSQ_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous arrays: first, sizes, lo
// (C,) int32; start, clen (n,) int32; curves (n, D) float32; acc (C, W)
// float32.  Members of cluster c are rows first[c] .. first[c] + sizes[c]
// - 1.  Returns cudaGetLastError() after the launch.
int ssq_sv_combine_logsum(const void* first, const void* sizes,
                          const void* lo, int C, const void* start,
                          const void* clen, const void* curves, int D, int W,
                          void* acc, void* stream) {
  return combine<int>(first, sizes, lo, C, start, clen, curves, D, W, acc,
                      stream);
}

// The same with first and sizes int64 (as torch.bincount and cumsum give
// them), so that the caller needs no conversion.
int ssq_sv_combine_logsum_i64(const void* first, const void* sizes,
                              const void* lo, int C, const void* start,
                              const void* clen, const void* curves, int D,
                              int W, void* acc, void* stream) {
  return combine<long long>(first, sizes, lo, C, start, clen, curves, D, W,
                            acc, stream);
}

}  // extern "C"
