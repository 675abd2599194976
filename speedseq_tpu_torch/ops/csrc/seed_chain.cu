// Hash k-mer seeding and NMS chaining of the align step's phase 1, for
// Hopper (sm_90a), behind a plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package computes this stage as jnp code
// (speedseq_tpu/index/kmer.py:find_seeds_hash, then
// speedseq_tpu/align/chain.py:chain_seeds_nms), and the port ran the same
// composition as ~1,600 small PyTorch ops an end.  One launch now does both
// ends of a step.  The specification is that composition, which
// ops/seed_chain.py keeps as the plain twin (seed_chain_plain); every output
// is bit-equal to it:
//   seeds   anchors at min(g * stride, max(L - k, 0)) of the padded width L,
//           on the read and on its reverse complement (the read's own
//           length); an anchor's k-mer keys its bucket (uint32 multiplies,
//           the twin's _mul32), the first max_scan entries are checked
//           against its fingerprint, and the first max_hits verified ones
//           in bucket order become seeds g * max_hits + h (forward strand
//           first); an anchor with an N, running past the read's length or
//           with more than max_occ entries has none.
//   chains  n_chains rounds: each live seed's group is the live seeds of
//           its strand within band of its diagonal; its weight is
//           min(span of the group's query intervals, k * members); the
//           pick is the largest w * 1024 + (S - 1 - slot) (int32, the
//           first on ties), its group is removed.  Every seed is k long,
//           so the twin's anchor (longest member, lowest slot) is the
//           group's lowest slot.  A round with no live seed gives the
//           twin's argmax-of-nothing: slot 0's length and strand (k, 0),
//           rpos -1, qpos 0, weight 0, qspan [2^20 - 1, 0).
//   pos, rend_pos  (anchor rpos - anchor qpos) + qspan_beg / qspan_end,
//           weight_candidates' arithmetic, so that no op follows.
//
// What bounds it on this card: the bucket gathers (bucket_start, then
// positions and fingerprints: ~100 MB of index, twice the L2, so each is a
// miss of ~0.6 us) and, at S = 2 * anchors * max_hits seeds, the rounds'
// n_live^2 pair tests a read.  Design: a block of 128 threads a read.  The
// read and its reverse complement go to shared memory; one thread a
// (strand, anchor, scan column), so each anchor's max_scan gathers are
// issued together by neighbouring lanes and the verified ones are ranked
// with one ballot.  The live seeds are compacted in slot order (a block
// prefix sum), so a round tests only live pairs, and a strand's seeds are
// one range.  A round: each thread takes seeds, scans its strand's range
// once for the group's bounds, count and lowest member, and keeps its best
// key; a block argmax picks; one more pass removes the group.  No device
// scratch, no host sync; outputs written once by thread 0 a round.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BIGQ = 1 << 20;
constexpr unsigned MULT_LO = 0x9E3779B1u;  // index/kmer.py's multipliers
constexpr unsigned MULT_HI = 0x85EBCA6Bu;
constexpr unsigned FP_LO = 0xC2B2AE35u;
constexpr unsigned FP_HI = 0x27D4EB2Fu;
constexpr int N_FIELDS = 9;  // ops/seed_chain.py:FIELDS

struct Params {
  const void* reads[2];  // (B[e], L[e]) codes of each end
  const int* lens[2];    // (B[e],)
  int L[2], B[2], G[2];  // width, reads and anchors of each end
  const int* bucket_start;
  const int* positions;
  const int* fp;
  int n_entries, shift;
  int k, stride, H, max_scan, P, max_occ, K, band;
  int N;                 // B[0] + B[1]
  int* out;              // (N_FIELDS, N, K)
  unsigned char* valid;  // (N, K)
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// |a - b| <= band as the twin's int32 (a - b).abs() <= band.
__device__ __forceinline__ bool near(int a, int b, int band) {
  const int d = wrap_sub(a, b);
  return (d < 0 ? (int)(0u - (unsigned)d) : d) <= band;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) seed_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wk[WARPS], s_wi[WARPS];
  __shared__ int s_nf;
  const int n = blockIdx.x;
  const int e = n < p.B[0] ? 0 : 1;
  const int b = e ? n - p.B[0] : n;
  const int L = p.L[e], G = p.G[e], H = p.H, k = p.k;
  const int GH = G * H, S = 2 * GH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* rd = static_cast<const T*>(p.reads[e]) + (size_t)b * L;
  const int len = p.lens[e][b];

  int* c_slot = reinterpret_cast<int*>(smem);  // live seeds, slot order
  int* c_rpos = c_slot + S;
  int* c_qpos = c_rpos + S;
  int* c_diag = c_qpos + S;
  int* c_mn = c_diag + S;  // a round's group bounds, count-capped weight
  int* c_mx = c_mn + S;    // and lowest member, a seed each
  int* c_lo = c_mx + S;
  int* c_w = c_lo + S;
  unsigned char* c_act = reinterpret_cast<unsigned char*>(c_w + S);
  unsigned char* s_fwd = c_act + S;
  unsigned char* s_rc = s_fwd + L;
  int* st_rpos = c_mn;  // seeds by slot before compaction (aliases)
  int* st_ok = c_lo;

  // the read and its reverse complement (index 4 past the read's length),
  // both clamped to 0..4 as the twin's anchor_keys does
  for (int q = tid; q < L; q += THREADS) {
    s_fwd[q] = (unsigned char)min(max((int)rd[q], 0), 4);
    const int idx = (int)((unsigned)len - 1u - (unsigned)q);
    const int v = (int)rd[min(max(idx, 0), L - 1)];
    const int comp = v < 4 ? (int)(3u - (unsigned)v) : v;
    s_rc[q] = (unsigned char)min(max(idx >= 0 ? comp : 4, 0), 4);
  }
  if (tid == 0) s_nf = 0;
  __syncthreads();

  // seeds: one thread a (strand, anchor, scan column j); P lanes an anchor
  const int total = 2 * G * p.P;
  const int maxa = max(L - k, 0);
  for (int base = 0; base < total; base += THREADS) {
    const int t = base + tid;
    const int grp = t / p.P, j = t & (p.P - 1);
    const bool in = t < total;
    const int s = grp >= G, g = s ? grp - G : grp;
    bool ok = false;
    int pos = -1;
    if (in) {
      const int a = min(g * p.stride, maxa);
      const unsigned char* r = s ? s_rc : s_fwd;
      unsigned lo = 0, hi = 0;
      bool bad = false;
      for (int q = 0; q < k; ++q) {
        unsigned c = r[a + q];
        bad |= c > 3u;
        c = c > 3u ? 0u : c;
        if (q < k - 16) hi = (hi << 2) | c;
        else lo = (lo << 2) | c;
      }
      if (!bad && a + k <= len) {
        const unsigned h = lo * MULT_LO ^ hi * MULT_HI;
        const unsigned f = lo * FP_LO ^ hi * FP_HI;
        const unsigned bkt = p.shift >= 32 ? 0u : h >> p.shift;
        const int st = __ldg(p.bucket_start + bkt);
        const long long nin = (long long)__ldg(p.bucket_start + bkt + 1) - st;
        if (nin <= p.max_occ && j < nin && j < p.max_scan) {
          const long long ci =
              min(max((long long)st + j, 0LL), (long long)p.n_entries - 1);
          pos = __ldg(p.positions + ci);
          ok = __ldg(p.fp + ci) == (int)(f >> 16);
        }
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    const unsigned gm = p.P == 32 ? m
        : (m >> (lane & ~(p.P - 1))) & ((1u << p.P) - 1u);
    if (in) {
      const int rank = __popc(gm & ((1u << j) - 1u));
      const int slot0 = s * GH + g * H;
      if (ok && rank < H) {
        st_rpos[slot0 + rank] = pos;
        st_ok[slot0 + rank] = 1;
      }
      if (j < H && j >= __popc(gm)) {
        st_rpos[slot0 + j] = -1;
        st_ok[slot0 + j] = 0;
      }
    }
  }
  __syncthreads();

  // compaction of the live seeds in slot order
  int n_v = 0;
  for (int base = 0; base < S; base += THREADS) {
    const int slot = base + tid;
    const bool v = slot < S && st_ok[slot];
    const int rp = v ? st_rpos[slot] : 0;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) s_wk[warp] = __popc(m);
    __syncthreads();
    int off = n_v, tot = 0;
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? s_wk[w] : 0;
      tot += s_wk[w];
    }
    off += __popc(m & ((1u << lane) - 1u));
    if (v) {
      const int qp = min((slot % GH) / H * p.stride, maxa);
      c_slot[off] = slot;
      c_rpos[off] = rp;
      c_qpos[off] = qp;
      c_diag[off] = (int)((unsigned)rp - (unsigned)qp + (unsigned)L);
      c_act[off] = 1;
    }
    n_v += tot;
    __syncthreads();
  }
  // live forward seeds: the first n_f
  for (int i = tid; i < n_v; i += THREADS)
    if (c_slot[i] < GH && (i + 1 == n_v || c_slot[i + 1] >= GH)) s_nf = i + 1;
  __syncthreads();
  const int n_f = s_nf;

  const size_t NK = (size_t)p.N * p.K;
  int* o = p.out + (size_t)n * p.K;
  for (int r = 0; r < p.K; ++r) {
    int bk = -1, bi = 0x7fffffff;
    for (int i = tid; i < n_v; i += THREADS) {
      if (!c_act[i]) continue;
      const int di = c_diag[i];
      const int j1 = i < n_f ? n_f : n_v;
      int mn = BIGQ, mx = 0, cnt = 0, lo = i;
      for (int j = i < n_f ? 0 : n_f; j < j1; ++j) {
        if (c_act[j] && near(di, c_diag[j], p.band)) {
          const int q = c_qpos[j];
          if (cnt == 0) lo = j;
          mn = min(mn, q);
          mx = max(mx, q + k);
          ++cnt;
        }
      }
      const int w = min(mx - mn, k * cnt);
      const int key = (int)((unsigned)w * 1024u + (unsigned)(S - 1 - c_slot[i]));
      c_mn[i] = mn;
      c_mx[i] = mx;
      c_lo[i] = lo;
      c_w[i] = w;
      if (key > bk) {  // i rises, so a tie keeps the lower slot
        bk = key;
        bi = i;
      }
    }
    for (int off = 16; off; off >>= 1) {
      const int ok2 = __shfl_down_sync(0xffffffffu, bk, off);
      const int oi2 = __shfl_down_sync(0xffffffffu, bi, off);
      if (ok2 > bk || (ok2 == bk && oi2 < bi)) {
        bk = ok2;
        bi = oi2;
      }
    }
    if (lane == 0) {
      s_wk[warp] = bk;
      s_wi[warp] = bi;
    }
    __syncthreads();
    bk = s_wk[0];
    bi = s_wi[0];
    for (int w = 1; w < WARPS; ++w)
      if (s_wk[w] > bk || (s_wk[w] == bk && s_wi[w] < bi)) {
        bk = s_wk[w];
        bi = s_wi[w];
      }
    if (bk < 0) {  // nothing live: this round and the rest are empty
      if (tid == 0)
        for (int rr = r; rr < p.K; ++rr) {
          const int f[N_FIELDS] = {-1, 0, k, 0, 0, BIGQ - 1, 0,
                                   wrap_sub(BIGQ - 1, 1), -1};
          for (int x = 0; x < N_FIELDS; ++x) o[x * NK + rr] = f[x];
          p.valid[(size_t)n * p.K + rr] = 0;
        }
      break;
    }
    if (tid == 0) {
      const int a = c_lo[bi];
      const int ar = c_rpos[a], aq = c_qpos[a];
      const int qb = min(c_mn[bi], BIGQ - 1), qe = c_mx[bi];
      const int d = wrap_sub(ar, aq);
      const int f[N_FIELDS] = {ar, aq, k, c_slot[a] >= GH, c_w[bi], qb, qe,
                               (int)((unsigned)d + (unsigned)qb),
                               (int)((unsigned)d + (unsigned)qe)};
      for (int x = 0; x < N_FIELDS; ++x) o[x * NK + r] = f[x];
      p.valid[(size_t)n * p.K + r] = 1;
    }
    const int db = c_diag[bi];
    const int j1 = bi < n_f ? n_f : n_v;
    for (int j = (bi < n_f ? 0 : n_f) + tid; j < j1; j += THREADS)
      if (c_act[j] && near(db, c_diag[j], p.band)) c_act[j] = 0;
    __syncthreads();
  }
}

// Dynamic shared memory of a block at S seeds and width L.
size_t smem_bytes(int S, int L) {
  return (size_t)S * (8 * sizeof(int) + 1) + 2 * (size_t)L;
}

template <typename T>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seed_chain_kernel<T><<<p.N, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may use (bytes), for the wrapper's
// check of S and L.
int ssq_seed_chain_smem(int S, int L) {
  const size_t b = smem_bytes(S, L);
  return b > 0x7fffffff ? 0x7fffffff : (int)b;
}

// All pointers are device pointers to contiguous arrays.  reads1 (B1, L1)
// and reads2 (B2, L2) hold codes as uint8 (reads_u8 = 1) or int32; lens1,
// lens2 int32; bucket_start (2^bits + 1,), positions and fp (n_entries,)
// int32; G1, G2 the anchors of each end; P the power of two >= max_scan
// (<= 32).  out (9, B1 + B2, K) int32 gets, per read of end 1 then end 2
// and round: anchor_rpos, anchor_qpos, anchor_len, strand, weight,
// qspan_beg, qspan_end, pos, rend_pos; valid (B1 + B2, K) bytes 0/1.
// Returns cudaGetLastError() after the launch.
int ssq_seed_chain(const void* reads1, const void* lens1, int B1, int L1,
                   int G1, const void* reads2, const void* lens2, int B2,
                   int L2, int G2, int reads_u8, const void* bucket_start,
                   const void* positions, const void* fp, int n_entries,
                   int bits, int k, int stride, int max_hits, int max_scan,
                   int P, int max_occ, int K, int band, void* out,
                   void* valid, void* stream) {
  Params p;
  p.reads[0] = reads1;
  p.reads[1] = reads2;
  p.lens[0] = static_cast<const int*>(lens1);
  p.lens[1] = static_cast<const int*>(lens2);
  p.L[0] = L1;
  p.L[1] = L2;
  p.B[0] = B1;
  p.B[1] = B2;
  p.G[0] = G1;
  p.G[1] = G2;
  p.bucket_start = static_cast<const int*>(bucket_start);
  p.positions = static_cast<const int*>(positions);
  p.fp = static_cast<const int*>(fp);
  p.n_entries = n_entries;
  p.shift = 32 - bits;
  p.k = k;
  p.stride = stride;
  p.H = max_hits;
  p.max_scan = max_scan;
  p.P = P;
  p.max_occ = max_occ;
  p.K = K;
  p.band = band;
  p.N = B1 + B2;
  p.out = static_cast<int*>(out);
  p.valid = static_cast<unsigned char*>(valid);
  if (p.N <= 0) return 0;
  const int Smax = 2 * std::max(G1 * max_hits, B2 > 0 ? G2 * max_hits : 0);
  const size_t smem = smem_bytes(Smax, std::max(L1, B2 > 0 ? L2 : 0));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reads_u8 ? launch<uint8_t>(p, smem, s) : launch<int>(p, smem, s);
}

}  // extern "C"
