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
// Design: a block of 128 threads a (cluster, 128-column tile), one thread
// a column, a serial loop over the cluster's members.  The member's start
// and length are one broadcast load each; its curve values for a tile's
// columns are neighbouring floats.
//
// What bounds it on this card: the logs (one MUFU.LG2 each, 16 a clock per
// SM) of the cells inside a member's curve, or the bytes (those cells read
// once, not the curves' padding); at one deep pile, one cluster's members
// are a serial chain of dependent adds a column, with only W / 128 blocks
// in flight.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    combine_logsum_kernel(const int* __restrict__ first,
                          const int* __restrict__ sizes,
                          const int* __restrict__ lo,
                          const int* __restrict__ start,
                          const int* __restrict__ clen,
                          const float* __restrict__ curves, int D, int W,
                          float* __restrict__ acc) {
  const int c = blockIdx.x;
  const int w = blockIdx.y * THREADS + threadIdx.x;
  if (w >= W) return;
  const float eps = 1e-12f;
  const float log_eps = logf(eps);
  const int f = first[c], m = sizes[c], lc = lo[c];
  float a = 0.0f;
#pragma unroll 4
  for (int r = 0; r < m; ++r) {
    const int row = f + r;
    const int rel = w - (start[row] - lc);
    float v = log_eps;
    if (rel >= 0 && rel < clen[row]) {
      const float x = curves[(long)row * D + min(max(rel, 0), D - 1)];
      v = logf(x != x ? x : fmaxf(x, eps));   // NaN stays NaN
    }
    a = __fadd_rn(a, v);
  }
  acc[(long)c * W + w] = a;
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
  if (C <= 0 || W <= 0) return 0;
  if (D < 1 || W > 65535 * THREADS) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)((W + THREADS - 1) / THREADS));
  combine_logsum_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)first, (const int*)sizes, (const int*)lo,
      (const int*)start, (const int*)clen, (const float*)curves, D, W,
      (float*)acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
