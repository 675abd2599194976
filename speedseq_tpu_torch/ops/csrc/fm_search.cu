// FMD-index search for FM (SMEM) seeding, hand-written for Hopper (sm_90a).
//
// fm_smem replaces the two lax.while_loops of
// speedseq_tpu/align/seeding.py:find_seeds (forward extension :92-112,
// backward extension :114-135), whose steps each run two occ_all lookups
// (speedseq_tpu/index/fm.py:179-264).  fm_sa_walk replaces the 32-step
// fori_loop of speedseq_tpu/index/fm.py:sa_lookup (:291-307).  Neither is a
// Pallas kernel: they are jitted loops whose torch form costs one host sync
// and ~40 launches per step.
//
// fm_smem: one thread per (read, anchor) lane runs the whole forward loop,
// then the whole backward loop, in registers, and writes the lane's SMEM
// [qbeg, qend), its bi-interval (k, s) and whether the anchor base opened
// an interval (alive0).  The loop bounds are the JAX package's (forward
// j < L, backward j <= L, L the padded read width); a lane stops at its
// first empty extension or non-ACGT base, where the JAX loop masks it dead.
// When an extension empties, the interval keeps its old k, l and s.
//
// fm_sa_walk: one thread per rank walks LF until a marked rank (every 32nd
// text position is marked, so at most 32 steps) and returns the sampled SA
// value plus the steps taken.
//
// occ counting: a checkpoint row (4 int32) plus, for each of the block's
// first `within` bases, a 2-bit pattern match of the packed word against
// each base and __popc.  The mask of the first v bases of a word is its top
// 2v bits; v = 0 and v = 16 are special-cased, because a C++ shift by 32 is
// undefined (XLA's gives 0).
//
// Bound (ops/fm_search.py: occ_ops and the OPS_* counts): a step needs two
// occ lookups of one or two base classes (1-2 popcounts and ~3-5 int32
// operations per word, 4.4 words on average), where this kernel counts all
// four bases; the least time is the larger of the int32 operations over
// 64 lanes/SM/clock and the popcounts over 16/SM/clock, and the bytes (the
// index and the reads read once, the outputs written once).  At 12 M ranks
// the index (4.5 MB of occ and BWT) stays in the 50 MB L2; above it, each
// step's gathers go to HBM.  A lane is a chain of dependent gathers (each
// step's ranks come from the previous step's counts), so a lane waits on
// latency; enough lanes in flight (one thread each, 128 a block) hide it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fmd {
  const int* __restrict__ count;     // (4,) C'[c] = 1 + L2[c]
  const int4* __restrict__ occ;      // (n_blocks+1) checkpoint rows
  const uint32_t* __restrict__ bwt;  // (n_blocks, 8) packed words
  int n_blocks, primary, seq_len;
  int c0, c1, c2, c3;                // count, loaded by each thread
};

__device__ __forceinline__ Fmd with_counts(Fmd f) {
  f.c0 = __ldg(f.count);
  f.c1 = __ldg(f.count + 1);
  f.c2 = __ldg(f.count + 2);
  f.c3 = __ldg(f.count + 3);
  return f;
}

__device__ __forceinline__ int pick(int a0, int a1, int a2, int a3, int c) {
  return c == 0 ? a0 : c == 1 ? a1 : c == 2 ? a2 : a3;
}

__device__ __forceinline__ int cnt(const Fmd& f, int c) {
  return pick(f.c0, f.c1, f.c2, f.c3, c);
}

// the first `valid` of a word's 16 bases sit in its top 2*valid bits
__device__ __forceinline__ uint32_t prefix_mask(int valid) {
  if (valid <= 0) return 0u;
  if (valid >= 16) return 0xFFFFFFFFu;
  return 0xFFFFFFFFu << (32 - 2 * valid);
}

__device__ __forceinline__ int matches(uint32_t x, uint32_t patt,
                                       uint32_t m) {
  uint32_t nx = ~(x ^ patt);
  return __popc(nx & (nx >> 1) & 0x55555555u & m);
}

// occurrences of each base in conceptual BWT rows [0, k) (bwa bwt_occ4)
__device__ __forceinline__ void occ4(const Fmd& f, int k, int& o0, int& o1,
                                     int& o2, int& o3) {
  int kk = k - (k > f.primary ? 1 : 0);
  kk = min(max(kk, 0), f.seq_len);
  int block = kk >> 7;
  int within = kk & 127;
  int4 ck = __ldg(f.occ + block);
  o0 = ck.x; o1 = ck.y; o2 = ck.z; o3 = ck.w;
  const uint32_t* w = f.bwt + (size_t)min(block, f.n_blocks - 1) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int valid = within - 16 * i;
    if (valid <= 0) break;
    uint32_t m = prefix_mask(valid);
    uint32_t x = __ldg(w + i);
    o0 += matches(x, 0x00000000u, m);
    o1 += matches(x, 0x55555555u, m);
    o2 += matches(x, 0xAAAAAAAAu, m);
    o3 += matches(x, 0xFFFFFFFFu, m);
  }
}

__device__ __forceinline__ int bwt_char(const Fmd& f, int k) {
  int kk = k - (k > f.primary ? 1 : 0);
  kk = min(max(kk, 0), f.seq_len - 1);
  uint32_t word = __ldg(f.bwt + (size_t)(kk >> 7) * 8 + ((kk & 127) >> 4));
  return (word >> ((15 - (kk & 15)) * 2)) & 3;
}

// bwa bwt_extend (is_back=1) of bi-interval (k, l, s) by base c (0-3):
// returns the new size; k and l change only when it is nonzero
__device__ __forceinline__ int back_ext(const Fmd& f, int& k, int& l, int s,
                                        int c) {
  int a0, a1, a2, a3, b0, b1, b2, b3;
  occ4(f, k, a0, a1, a2, a3);
  occ4(f, k + s, b0, b1, b2, b3);
  int ns = pick(b0 - a0, b1 - a1, b2 - a2, b3 - a3, c);
  if (ns > 0) {
    int sent = (f.primary >= k && f.primary < k + s) ? 1 : 0;
    int up = (c < 1 ? b1 - a1 : 0) + (c < 2 ? b2 - a2 : 0) +
             (c < 3 ? b3 - a3 : 0);
    l = l + sent + up;
    k = cnt(f, c) + pick(a0, a1, a2, a3, c);
  }
  return ns;
}

__global__ void fm_smem_kernel(const uint8_t* __restrict__ reads,
                               const int* __restrict__ lengths, int B, int L,
                               const int* __restrict__ starts, int G,
                               Fmd fp, int* __restrict__ qbeg_o,
                               int* __restrict__ qend_o,
                               int* __restrict__ k_o, int* __restrict__ s_o,
                               uint8_t* __restrict__ alive_o) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * G) return;
  const Fmd f = with_counts(fp);
  int b = i / G;
  const uint8_t* row = reads + (size_t)b * L;
  int rlen = __ldg(lengths + b);
  int p = __ldg(starts + i - b * G);
  // reads[b, q] inside the read's length, else 4 (N / padding)
  auto base = [&](int q) -> int {
    return (q >= 0 && q < rlen) ? (int)__ldg(row + min(q, L - 1)) : 4;
  };

  int c = base(p);
  int k, l, s;
  if (c < 4) {  // bwa bwt_set_intv
    k = cnt(f, c);
    s = (c < 3 ? cnt(f, c + 1) : f.seq_len + 1) - k;
    l = cnt(f, 3 - c);
  } else {
    k = l = f.c3;
    s = 0;
  }
  bool alive0 = c < 4 && s > 0;
  int qend = alive0 ? p + 1 : p;
  if (alive0) {
    // forward: append read[p + j], i.e. backward-extend the mirror
    // interval (l, k) by the complement, then swap back
    for (int j = 1; j < L; ++j) {
      c = base(p + j);
      if (c >= 4) break;
      int ns = back_ext(f, l, k, s, 3 - c);
      if (ns <= 0) break;
      s = ns;
      qend = p + j + 1;
    }
  }
  int qbeg = p;
  if (alive0) {
    // backward: prepend read[p - j]
    for (int j = 1; j <= L; ++j) {
      c = base(p - j);
      if (c >= 4) break;
      int ns = back_ext(f, k, l, s, c);
      if (ns <= 0) break;
      s = ns;
      qbeg = p - j;
    }
  }
  qbeg_o[i] = qbeg;
  qend_o[i] = qend;
  k_o[i] = k;
  s_o[i] = s;
  alive_o[i] = alive0 ? 1 : 0;
}

__global__ void fm_sa_walk_kernel(const int* __restrict__ ranks, int n, Fmd fp,
                                  const uint32_t* __restrict__ sa_mark,
                                  const int* __restrict__ sa_ckpt,
                                  const int* __restrict__ sa_vals, int n_vals,
                                  int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fmd f = with_counts(fp);
  int r = __ldg(ranks + i);
  int steps = 0;
  uint32_t w = __ldg(sa_mark + (r >> 5));
  for (int it = 0; it < 32; ++it) {
    if ((w >> (r & 31)) & 1u) break;
    int c = bwt_char(f, r);
    int o0, o1, o2, o3;
    occ4(f, r, o0, o1, o2, o3);
    r = cnt(f, c) + pick(o0, o1, o2, o3, c);
    ++steps;
    w = __ldg(sa_mark + (r >> 5));
  }
  int at = __ldg(sa_ckpt + (r >> 5)) + __popc(w & ((1u << (r & 31)) - 1u));
  at = min(max(at, 0), n_vals - 1);
  out[i] = __ldg(sa_vals + at) + steps;
}

Fmd make_fmd(const int* count, const int* occ, const uint32_t* bwt,
             int n_blocks, int primary, int seq_len) {
  Fmd f;
  f.count = count;
  f.occ = reinterpret_cast<const int4*>(occ);
  f.bwt = bwt;
  f.n_blocks = n_blocks;
  f.primary = primary;
  f.seq_len = seq_len;
  f.c0 = f.c1 = f.c2 = f.c3 = 0;
  return f;
}

}  // namespace

// every pointer is device memory
extern "C" int ssq_fm_smem(const uint8_t* reads, const int* lengths, int B,
                           int L, const int* starts, int G, const int* count,
                           const int* occ, const uint32_t* bwt, int n_blocks,
                           int primary, int seq_len, int* qbeg, int* qend,
                           int* k, int* s, uint8_t* alive0,
                           cudaStream_t stream) {
  int n = B * G;
  if (n <= 0) return 0;
  const int threads = 128;
  fm_smem_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      reads, lengths, B, L, starts, G,
      make_fmd(count, occ, bwt, n_blocks, primary, seq_len), qbeg, qend, k, s,
      alive0);
  return (int)cudaGetLastError();
}

extern "C" int ssq_fm_sa_walk(const int* ranks, int n, const int* count,
                              const int* occ, const uint32_t* bwt,
                              int n_blocks, int primary, int seq_len,
                              const uint32_t* sa_mark, const int* sa_ckpt,
                              const int* sa_vals, int n_vals, int* out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  fm_sa_walk_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      ranks, n, make_fmd(count, occ, bwt, n_blocks, primary, seq_len),
      sa_mark, sa_ckpt, sa_vals, n_vals, out);
  return (int)cudaGetLastError();
}
