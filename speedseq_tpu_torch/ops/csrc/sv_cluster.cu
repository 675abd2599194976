// Cluster sweep over LUMPY evidence, hand-written for Hopper (sm_90a).
//
// Replaces the serial lax.scan of speedseq_tpu/sv/device.py:_cluster_scan_jit
// (not a Pallas kernel: a jitted scan with one step per evidence row).
//
// Input: evidence rows sorted by (gid, start1, start2) as int32 columns
// gid, s1, e1 (= start1 + len1), lo2 (= start2), hi2 (= start2 + len2).  A
// row starts a new cluster when its gid differs from the previous row's or
// when it fails the 2-D overlap test against the cluster's running extents
// (max end1 em, min lo2, max hi2).  Output: each row's cluster id.
//
// What bounded the first design: one thread walked each whole gid segment
// serially, so a genome's few huge groups set the time (8.5 ms at 1,048,576
// rows in 16 groups), and its wrapper synced with the host twice (the
// segment starts by torch.nonzero, the global ids by repeat_interleave),
// which set the time at the sv cell's few hundred rows.
//
// The exact split this design rests on: let P_i be the largest e1 of the
// rows before row i in its gid.  A cluster's running em is the e1 of some
// earlier row, so em <= P_i, and a row with s1_i >= P_i fails the overlap
// test: it always starts a cluster (a forced break), as does a gid change.
// The carry restarts at every such row, so the pieces between forced breaks
// are independent.  Rows sorted by gid give every row's (gid, P_i) from one
// max-scan of the int64 keys (gid << 32) | (e1 ^ 0x80000000) over the rows
// before it: the high word is the previous row's gid, the low word e1's
// order as unsigned, and the scan's identity (INT64_MIN) breaks at row 0.
//
// Launches (no host sync; scratch from the wrapper):
//   n <= ONE_BLOCK_ROWS: one block of 512 threads, 4 rows each, does it
//     all: the key scan, the piece walks (flags in shared memory), then an
//     integer scan of the flags into ids;
//   else, tiles of TILE_ROWS rows, one block of 256 threads each:
//     1. tile_max: each tile's largest key;
//     2. scan_tiles (one block): exclusive max-scan of the tile keys;
//     3. walk: each row's key prefix and forced-break flag (into shared
//        memory, with the next tile's first row's); a leader whose next
//        row breaks is a one-row piece (most are) and costs no load, and
//        the leader of a longer one walks it (the serial overlap test,
//        rows loaded in groups of UNROLL, the next group in flight while
//        one is walked), writing each row's flag (1: it starts a
//        cluster);
//     4. tile_count: each tile's count of flags;
//     5. scan_tiles (one block): exclusive sum-scan of the tile counts;
//     6. ids: each tile's inclusive scan of its flags plus its offset,
//        less one.
// The one-block plan is the tiled plan's work in one launch: at the sv
// cell's 356 rows it took 0.036 ms a call against the tiles' 0.051-0.058
// (device 0.008 against 0.019, on an H100; PERF.md).  Slower in turns: the
// tile counts added up in the walk by atomics, 16 rows a group, a group
// walked without a branch per row.  UNROLL = 8 rests on a guessed shape: 4 and 8
// tie at the sv cell's rows, 8 is faster on the synthetic genome-piles, 4
// on the synthetic genome.
// A walker decides where its piece ends from the same running max key
// that the tile scan gives each row (while no break comes, its high word
// stays the piece's gid and its low word is the max of end1, so 32-bit
// state holds it), so every row is written by exactly one walker,
// whatever the input.
//
// Bound: the bytes (five int32 columns read, one written) over the HBM
// rate, or the longest piece's serial chain of carry updates, whichever is
// larger; the walk's time is its longest piece (a pile of overlapping rows)
// plus ~6 short launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_THREAD = 4;
constexpr int TILE_THREADS = 256;
constexpr int TILE_ROWS = TILE_THREADS * ROWS_PER_THREAD;   // 1,024
constexpr int ONE_BLOCK_THREADS = 512;
constexpr int ONE_BLOCK_ROWS = ONE_BLOCK_THREADS * ROWS_PER_THREAD;
constexpr int UNROLL = 8;
constexpr long long KEY_NONE = -0x7FFFFFFFFFFFFFFFLL - 1;   // INT64_MIN

struct Sweep {
  const int* __restrict__ gid;
  const int* __restrict__ s1;
  const int* __restrict__ e1;
  const int* __restrict__ lo2;
  const int* __restrict__ hi2;
  int n;
};

struct Max64 {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

struct Sum32 {
  __device__ int operator()(int a, int b) const { return a + b; }
};

__device__ __forceinline__ long long sweep_key(int g, int e) {
  return (long long)(((unsigned long long)(unsigned)g << 32) |
                     (unsigned)(e ^ (int)0x80000000));
}

// row (g, s) after rows whose largest key is `prev` starts a piece: a gid
// change, or s at or past the largest e1 of its gid's earlier rows
__device__ __forceinline__ bool forced_break(long long prev, int g, int s) {
  return (int)(prev >> 32) != g ||
         s >= (int)((unsigned)prev ^ 0x80000000u);
}

// exclusive scan over the block (blockDim.x a multiple of 32); `total`
// gets the block's reduction; `warp_tot` is 32 entries of shared memory
template <typename T, typename Op>
__device__ T block_exclusive(T v, T id, Op op, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T y = lane < nw ? warp_tot[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T z = __shfl_up_sync(0xFFFFFFFFu, y, o);
      if (lane >= o) y = op(z, y);
    }
    warp_tot[lane] = y;
  }
  __syncthreads();
  const T before = wid > 0 ? warp_tot[wid - 1] : id;
  T ex = __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (lane == 0) ex = id;
  total = warp_tot[nw - 1];
  __syncthreads();          // warp_tot is free again
  return op(before, ex);
}

struct Rows {
  int g[ROWS_PER_THREAD], s[ROWS_PER_THREAD], e[ROWS_PER_THREAD];
  int lo[ROWS_PER_THREAD], hi[ROWS_PER_THREAD];
  long long key[ROWS_PER_THREAD];
  long long max;            // the largest of this thread's keys
};

__device__ __forceinline__ Rows load_rows(const Sweep& w, int first) {
  Rows r;
  r.max = KEY_NONE;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = first + k;
    if (i < w.n) {
      r.g[k] = __ldg(w.gid + i);
      r.s[k] = __ldg(w.s1 + i);
      r.e[k] = __ldg(w.e1 + i);
      r.lo[k] = __ldg(w.lo2 + i);
      r.hi[k] = __ldg(w.hi2 + i);
      r.key[k] = sweep_key(r.g[k], r.e[k]);
    } else {
      r.key[k] = KEY_NONE;
    }
    r.max = max(r.max, r.key[k]);
  }
  return r;
}

// a walker's carry: the forced-break state (the gid G and the largest
// end1 P of the running max key: a row breaks when its gid is not G or its
// start1 reaches P, and else P takes the max of its end1) and the
// cluster's extents
struct Walker {
  int G, P, em, l2, h2;
};

struct Group {
  int g[UNROLL], s[UNROLL], e[UNROLL], lo[UNROLL], hi[UNROLL];
};

__device__ __forceinline__ void load_group(const Sweep& w, int j0,
                                           Group& v) {
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int j = min(j0 + k, w.n - 1);
    v.g[k] = __ldg(w.gid + j);
    v.s[k] = __ldg(w.s1 + j);
    v.e[k] = __ldg(w.e1 + j);
    v.lo[k] = __ldg(w.lo2 + j);
    v.hi[k] = __ldg(w.hi2 + j);
  }
}

// rows j0.. of a group: false at the piece's end (a forced break or the
// last row), each row before it tested against the cluster and flagged
__device__ __forceinline__ bool walk_group(Walker& k, const Sweep& w, int j0,
                                           const Group& v, int* flag) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + u;
    if (j >= w.n || v.g[u] != k.G || v.s[u] >= k.P) return false;
    k.P = max(k.P, v.e[u]);
    const bool ov = v.s[u] < k.em && v.lo[u] < k.h2 && v.hi[u] > k.l2;
    k.em = ov ? max(k.em, v.e[u]) : v.e[u];
    k.l2 = ov ? min(k.l2, v.lo[u]) : v.lo[u];
    k.h2 = ov ? max(k.h2, v.hi[u]) : v.hi[u];
    flag[j] = ov ? 0 : 1;
  }
  return true;
}

// the piece that row i leads (its extents given; `run` the largest key of
// the rows up to i; row i + 1 in the piece): the serial overlap test over
// its rows up to the next forced break, each row's flag written (1: it
// starts a cluster), the rows loaded UNROLL at a time, the next group in
// flight while one is walked
__device__ void walk_piece(const Sweep& w, int i, int em, int l2, int h2,
                           long long run, int* flag) {
  flag[i] = 1;
  Walker k;
  k.G = (int)(run >> 32);
  k.P = (int)((unsigned)run ^ 0x80000000u);
  k.em = em;
  k.l2 = l2;
  k.h2 = h2;
  Group a, b;
  load_group(w, i + 1, a);
  for (int j = i + 1;; j += 2 * UNROLL) {   // rows < 2^31 - 2048
    load_group(w, j + UNROLL, b);
    if (!walk_group(k, w, j, a, flag)) return;
    load_group(w, j + 2 * UNROLL, a);
    if (!walk_group(k, w, j + UNROLL, b, flag)) return;
  }
}

// the forced-break test on this thread's rows (prev: the largest key
// before them): brk[i - base] = 1 where row i breaks (rows past n count as
// breaks, so that they end the pieces before them), run[k] = the largest
// key of the rows up to row first + k; returns a bit per row that leads
__device__ __forceinline__ unsigned mark_breaks(const Sweep& w, int first,
                                                int base, const Rows& r,
                                                long long prev,
                                                unsigned char* brk,
                                                long long* run) {
  unsigned lead = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = first + k;
    bool b = true;
    if (i < w.n) {
      b = forced_break(prev, r.g[k], r.s[k]);
      prev = max(prev, r.key[k]);
      lead |= (b ? 1u : 0u) << k;
    }
    brk[i - base] = b ? 1 : 0;
    run[k] = prev;
  }
  return lead;
}

// with every break of the block's rows (and of the row after them) in
// brk: each piece this thread leads, a piece whose next row breaks being
// one row, with no load
__device__ void walk_rows(const Sweep& w, int first, int base, unsigned lead,
                          const long long* run, const unsigned char* brk,
                          int* flag) {
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    if (!((lead >> k) & 1u)) continue;
    const int i = first + k;
    if (brk[i + 1 - base])
      flag[i] = 1;
    else
      walk_piece(w, i, __ldg(w.e1 + i), __ldg(w.lo2 + i), __ldg(w.hi2 + i),
                 run[k], flag);
  }
}

// the ids of a block's rows from their flags (1: the row starts a
// cluster) and the clusters started before the block
__device__ __forceinline__ void write_ids(int n, int first, const int* flag,
                                          int before, int* cnt_tot,
                                          int* out) {
  int f[ROWS_PER_THREAD], sum = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    f[k] = first + k < n ? flag[k] : 0;
    sum += f[k];
  }
  int total;
  int at = before + block_exclusive(sum, 0, Sum32(), cnt_tot, total);
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    at += f[k];
    if (first + k < n) out[first + k] = at - 1;
  }
}

__global__ void __launch_bounds__(ONE_BLOCK_THREADS)
    sweep_one_block(Sweep w, int* __restrict__ out) {
  __shared__ int flag[ONE_BLOCK_ROWS];
  __shared__ unsigned char brk[ONE_BLOCK_ROWS + 1];
  __shared__ long long key_tot[32];
  __shared__ int cnt_tot[32];
  const int first = threadIdx.x * ROWS_PER_THREAD;
  long long run[ROWS_PER_THREAD];
  unsigned lead;
  {
    const Rows r = load_rows(w, first);
    long long key_all;
    const long long prev =
        block_exclusive(r.max, KEY_NONE, Max64(), key_tot, key_all);
    lead = mark_breaks(w, first, 0, r, prev, brk, run);
  }
  if (threadIdx.x == 0) brk[ONE_BLOCK_ROWS] = 1;
  __syncthreads();
  walk_rows(w, first, 0, lead, run, brk, flag);
  __syncthreads();
  write_ids(w.n, first, flag + first, 0, cnt_tot, out);
}

__global__ void __launch_bounds__(TILE_THREADS)
    sweep_tile_max(Sweep w, long long* __restrict__ tile_key) {
  __shared__ long long key_tot[32];
  const Rows r = load_rows(w, blockIdx.x * TILE_ROWS +
                                  threadIdx.x * ROWS_PER_THREAD);
  long long all;
  block_exclusive(r.max, KEY_NONE, Max64(), key_tot, all);
  if (threadIdx.x == 0) tile_key[blockIdx.x] = all;
}

// exclusive scan of v[0, nb) in place, one block
template <typename T, typename Op>
__global__ void __launch_bounds__(1024)
    sweep_scan_tiles(T* __restrict__ v, int nb, T id, Op op) {
  __shared__ T warp_tot[32];
  T carry = id;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const T x = i < nb ? v[i] : id;
    T tot;
    const T ex = block_exclusive(x, id, op, warp_tot, tot);
    if (i < nb) v[i] = op(carry, ex);
    carry = op(carry, tot);
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
    sweep_walk(Sweep w, const long long* __restrict__ tile_prev,
               int* __restrict__ flag) {
  __shared__ unsigned char brk[TILE_ROWS + 1];
  __shared__ long long key_tot[32];
  const int base = blockIdx.x * TILE_ROWS;
  const int first = base + threadIdx.x * ROWS_PER_THREAD;
  long long run[ROWS_PER_THREAD];
  unsigned lead;
  {
    const Rows r = load_rows(w, first);
    long long all;
    const long long ex =
        block_exclusive(r.max, KEY_NONE, Max64(), key_tot, all);
    const long long carry = tile_prev[blockIdx.x];
    lead = mark_breaks(w, first, base, r, max(carry, ex), brk, run);
    if (threadIdx.x == 0) {       // the next tile's first row
      const int next = base + TILE_ROWS;
      brk[TILE_ROWS] = next >= w.n || forced_break(max(carry, all),
                                                   __ldg(w.gid + next),
                                                   __ldg(w.s1 + next));
    }
  }
  __syncthreads();
  walk_rows(w, first, base, lead, run, brk, flag);
}

// each tile's count of cluster starts
__global__ void __launch_bounds__(TILE_THREADS)
    sweep_tile_count(int n, const int* __restrict__ flag,
                     int* __restrict__ tile_count) {
  __shared__ int cnt_tot[32];
  const int first = blockIdx.x * TILE_ROWS + threadIdx.x * ROWS_PER_THREAD;
  int sum = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k)
    sum += first + k < n ? flag[first + k] : 0;
  int total;
  block_exclusive(sum, 0, Sum32(), cnt_tot, total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(TILE_THREADS)
    sweep_ids(int n, const int* __restrict__ tile_offset,
              int* __restrict__ out) {
  __shared__ int cnt_tot[32];
  const int first = blockIdx.x * TILE_ROWS + threadIdx.x * ROWS_PER_THREAD;
  int f[ROWS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k)
    f[k] = first + k < n ? out[first + k] : 0;
  write_ids(n, first, f, tile_offset[blockIdx.x], cnt_tot, out);
}

}  // namespace

// every pointer is device memory; tile_key (int64) and tile_count (int32)
// hold ceil(n / 1,024) entries each (unused when n <= 2,048); out gets the
// cluster ids
extern "C" int ssq_sv_cluster(const int* gid, int n, const int* s1,
                              const int* e1, const int* lo2, const int* hi2,
                              long long* tile_key, int* tile_count, int* out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const Sweep w{gid, s1, e1, lo2, hi2, n};
  if (n <= ONE_BLOCK_ROWS) {
    sweep_one_block<<<1, ONE_BLOCK_THREADS, 0, stream>>>(w, out);
    return (int)cudaGetLastError();
  }
  const int nb = (n + TILE_ROWS - 1) / TILE_ROWS;
  sweep_tile_max<<<nb, TILE_THREADS, 0, stream>>>(w, tile_key);
  sweep_scan_tiles<<<1, 1024, 0, stream>>>(tile_key, nb, KEY_NONE, Max64());
  sweep_walk<<<nb, TILE_THREADS, 0, stream>>>(w, tile_key, out);
  sweep_tile_count<<<nb, TILE_THREADS, 0, stream>>>(n, out, tile_count);
  sweep_scan_tiles<<<1, 1024, 0, stream>>>(tile_count, nb, 0, Sum32());
  sweep_ids<<<nb, TILE_THREADS, 0, stream>>>(n, tile_count, out);
  return (int)cudaGetLastError();
}
