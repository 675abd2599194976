// Cluster sweep over LUMPY evidence, hand-written for Hopper (sm_90a).
//
// Replaces the serial lax.scan of speedseq_tpu/sv/device.py:_cluster_scan_jit
// (not a Pallas kernel: a jitted scan with one step per evidence row).
//
// Input: evidence rows sorted by (gid, start1, start2) as int32 columns
// gid, s1, e1 (= start1 + len1), lo2 (= start2), hi2 (= start2 + len2), and
// the first row of each gid segment.  A row starts a new cluster when its
// gid differs from the previous row's or when it fails the 2-D overlap
// test against the cluster's running extents (max end1, min lo2, max hi2).
//
// Design: a gid change always starts a cluster, so segments are
// independent.  One thread per segment walks its rows serially, writing
// segment-local cluster ids and the segment's cluster count; the wrapper
// turns counts into global offsets with an exclusive integer cumsum.
//
// Bound: the bytes (five int32 columns read, one written) over the HBM
// rate, or the longest segment's serial chain of carry updates, whichever
// is larger; at a genome's evidence counts with few segments the chain
// dominates.  The loop loads UNROLL rows ahead of the carry, so the loads
// are independent of the chain and only the compare/select chain is serial.

#include <cuda_runtime.h>

#define UNROLL 8

__global__ void sv_cluster_kernel(const int* __restrict__ seg_start,
                                  int n_seg, int n,
                                  const int* __restrict__ s1,
                                  const int* __restrict__ e1,
                                  const int* __restrict__ lo2,
                                  const int* __restrict__ hi2,
                                  int* __restrict__ local,
                                  int* __restrict__ count) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_seg) return;
  int a = seg_start[g];
  int b = (g + 1 < n_seg) ? seg_start[g + 1] : n;
  int em = 0, l2 = 0, h2 = 0, cid = 0;
  for (int i0 = a; i0 < b; i0 += UNROLL) {
    int vs[UNROLL], ve[UNROLL], vl[UNROLL], vh[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      int i = i0 + k;
      if (i < b) {
        vs[k] = __ldg(s1 + i);
        ve[k] = __ldg(e1 + i);
        vl[k] = __ldg(lo2 + i);
        vh[k] = __ldg(hi2 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      int i = i0 + k;
      if (i < b) {
        bool ov = (i > a) && (vs[k] < em) && (vl[k] < h2) && (vh[k] > l2);
        if (ov) {
          em = max(em, ve[k]);
          l2 = min(l2, vl[k]);
          h2 = max(h2, vh[k]);
        } else {
          ++cid;
          em = ve[k];
          l2 = vl[k];
          h2 = vh[k];
        }
        local[i] = cid - 1;
      }
    }
  }
  count[g] = cid;
}

extern "C" int ssq_sv_cluster(const int* seg_start, int n_seg, int n,
                              const int* s1, const int* e1, const int* lo2,
                              const int* hi2, int* local, int* count,
                              cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  const int threads = 128;
  int blocks = (n_seg + threads - 1) / threads;
  sv_cluster_kernel<<<blocks, threads, 0, stream>>>(
      seg_start, n_seg, n, s1, e1, lo2, hi2, local, count);
  return (int)cudaGetLastError();
}
