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
// fm_smem: one thread per (read, anchor) lane extends the anchor's interval
// forward, then backward, in registers, and writes the lane's SMEM
// [qbeg, qend), its bi-interval (k, s) and whether the anchor base opened
// an interval (alive0).  The loop bounds are the JAX package's (forward
// j < L, backward j <= L, L the padded read width); a lane stops a phase at
// its first empty extension or non-ACGT base, where the JAX loop masks it
// dead.  When an extension empties, the interval keeps its old k, l and s.
//
// What bounded the first design (each step two full bwt_occ4 lookups, at
// k and at k + s; the forward loop, then the backward loop):
//   1. load requests: a lookup read its 16-byte checkpoint row, then one
//      4-byte word per 16 bases below `within` (4.44 on average): 10.9
//      requests a step, every lane on its own cache line, so each of a
//      warp's loads is 32 L1 wavefronts;
//   2. serial loads: the word loop broke before each load and used each
//      word at once, so a step's loads were not in flight together;
//   3. the lookup at k + s fetched the block the lookup at k had fetched
//      whenever both fall in it, as they do on nearly every step once s is
//      small (bwa's bwt_2occ4 fetches it once);
//   4. both lookups counted all four bases, where a step needs the base's
//      class and the classes above it;
//   5. a warp ran its longest forward lane, then its longest backward lane:
//      ~max(forward) + max(backward) iterations with about half the lanes
//      busy.
// This design:
//   1, 3. A lookup of stored row r reads one checkpoint row and one 64-base
//      half-block (an int4 and a uint4 load): the lower half, counted up
//      from the block's checkpoint, while r is in it; the upper half,
//      counted down from the next block's checkpoint, above it (checkpoint
//      b+1 is checkpoint b plus block b's counts, as they count the stored
//      BWT; a partial last block counts up, adding its lower half).  A step
//      takes the stored rows r1 = k and r2 = k + s (sentinel row skipped):
//      when [r1, r2) lies in r1's half, or runs from its upper half to the
//      block's end, the step counts everything from r1's half; else (r2
//      in another half: the first steps of a lane, while s is large) it
//      looks up r2 as well, both lookups' loads issued before either count.
//   2. Every load is a 16-byte vector load issued before any count;
//      prefix masks replace the break.
//   4. Only the classes a base c needs: c itself, and for the mirror rank
//      the classes above c (c = 1 the high bit, c = 2 high & low, c = 3
//      none, c = 0 the rest of the range, r2 - r1 - n_c).  Two words'
//      class bits share one popcount (one on the even bits, one shifted to
//      the odd bits).
//   5. One loop for both phases: a lane whose forward extension stops turns
//      its interval to the backward orientation and goes on in the same
//      iteration, so a warp runs ~max(forward + backward) iterations.
// Index load requests a step, reckoned from the code (not measured): 10.9
// before; now 2 when one half holds the step, 4 when it takes two lookups
// (~7 % of the align cell's steps: about log4(12 M / 64) of a lane's ~134
// start with s above 64), ~2.1 on average.  Each step also reads one byte
// of the read, as before.
//
// fm_sa_walk: per rank, the LF walk until a marked rank (every 32nd text
// position is marked, so at most 32 steps); returns the sampled SA value
// plus the steps taken.  What bounded the first design: a step was two
// dependent rounds of loads on three arrays (the rank-space mark word,
// tested first; then the BWT word and bwt_occ4's checkpoint row and up to
// 8 words, read in a loop that could break), ~7 load instructions and,
// beyond the L2, three random DRAM accesses a step, counting all four
// bases where LF needs one.  This design reads the index's walk records
// (index/fm.py: walk_records): one 64-byte record per 128-row block of
// stored rows, its checkpoint taken at the block's middle row, its 8 BWT
// words, and its rows' mark bits in stored-row space.  A step's three
// loads (the checkpoint, the 16-byte half-block the row falls in, the
// mark word) depend on the rank alone and come from one record, so they
// are issued together and touch one 64-byte line: a row of the lower half
// counts its base down to the checkpoint, a row of the upper half up from
// it (a partial last block's lower half ends at seq_len).  The sentinel
// rank (primary: SA 0, marked) has no stored row and is tested apart.
// One rank a thread: two or four interleaved a thread were slower at the
// ranks find_seeds passes (PERF.md).
//
// occ counting: a 2-bit pattern match of a packed word against a base and
// __popc.  The mask of a word's first v bases is its top 2v bits, taken by
// a clamped funnel shift (v = 0 and v = 16 need no special case, where a
// C++ shift by 32 would be undefined).
//
// Bound (ops/fm_search.py: occ_ops and the OPS_* counts): a step needs two
// occ lookups of one or two base classes (1-2 popcounts and ~3-5 int32
// operations per word, 4.4 words on average); the least time is the larger
// of the int32 operations over 64 lanes/SM/clock and the popcounts over
// 16/SM/clock, and the bytes (the index and the reads read once, the
// outputs written once).  At 12 M ranks the index (4.5 MB of occ and BWT)
// stays in the 50 MB L2; above it, each step's gathers go to HBM.  A lane
// is a chain of dependent gathers (each step's ranks come from the previous
// step's counts), so a lane waits on latency; enough lanes in flight (one
// thread each, 128 a block) hide it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fmd {
  const int* __restrict__ count;     // (4,) C'[c] = 1 + L2[c]
  const int4* __restrict__ occ;      // (n_blocks+1) checkpoint rows
  const uint32_t* __restrict__ bwt;  // (n_blocks, 8) packed words
  const uint4* __restrict__ bwt4;    // the same words, (n_blocks, 2) halves
  int n_blocks, full_blocks, primary, seq_len;
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

template <typename F>
__device__ __forceinline__ int cnt(const F& f, int c) {
  return pick(f.c0, f.c1, f.c2, f.c3, c);
}

// ---------------------------------------------- fm_smem's extension step

// stored BWT row of conceptual row k (the sentinel row is not stored)
__device__ __forceinline__ int stored_row(const Fmd& f, int k) {
  int kk = k - (k > f.primary ? 1 : 0);
  return min(max(kk, 0), f.seq_len);
}

// a word's first v bases (v clamped to [0, 16]): its top 2v bits
__device__ __forceinline__ uint32_t top_bases(int v) {
  return __funnelshift_rc(0u, 0xFFFFFFFFu, (uint32_t)max(2 * v, 0));
}

// per base c: its code in every slot, and the classes above it as
// (x >> 1) & (x | gor) & gmask (c = 1 the high bit, c = 2 high & low)
struct Classes {
  uint32_t cm, gor, gmask;
};

__device__ __forceinline__ Classes classes_of(int c) {
  Classes k;
  k.cm = 0x55555555u * (uint32_t)c;
  k.gor = c == 1 ? 0xFFFFFFFFu : 0u;
  k.gmask = (c == 1 || c == 2) ? 0x55555555u : 0u;
  return k;
}

// one bit per base (the slot's low bit): the base is c / is above c
__device__ __forceinline__ uint32_t is_c(uint32_t x, const Classes& k) {
  uint32_t t = ~(x ^ k.cm);
  return t & (t >> 1) & 0x55555555u;
}

__device__ __forceinline__ uint32_t above_c(uint32_t x, const Classes& k) {
  return (x >> 1) & (x | k.gor) & k.gmask;
}

// set bits of four low-bit masks, two words to a popcount
__device__ __forceinline__ int popc4(uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  return __popc(a | (b << 1)) + __popc(c | (d << 1));
}

__device__ __forceinline__ int above_ck(int4 ck, int c) {
  return c == 1 ? ck.z + ck.w : c == 2 ? ck.w : 0;
}

// the half-block a lookup of stored row r counts from: the lower half,
// up from the block's checkpoint, while r is in it; the upper half, down
// from the next block's checkpoint, above it (a partial last block counts
// up, its whole lower half added); its loads, the half only when `reach`
// (the furthest base the caller counts to) needs it
struct Half {
  int4 ck;
  uint4 v, lo;
  int a;            // r's base within v
  bool down, upper;
};

__device__ __forceinline__ Half load_half(const Fmd& f, int r, int reach) {
  const int blk = r >> 7, w = r & 127;
  const uint4* row = f.bwt4 + 2 * (size_t)min(blk, f.n_blocks - 1);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  Half h;
  h.down = w >= 64 && blk < f.full_blocks;
  h.upper = h.down || w > 64;
  h.a = w - (h.upper ? 64 : 0);
  h.ck = __ldg(f.occ + blk + (h.down ? 1 : 0));
  h.v = (h.upper || reach > 0) ? __ldg(row + (h.upper ? 1 : 0)) : zero;
  h.lo = (h.upper && !h.down) ? __ldg(row) : zero;
  return h;
}

// from a loaded half: c's occurrences (oc) and the bases above c (og) in
// stored rows [0, r), and c's (n) and the above-c bases (up) among the
// half's bases [a, z)
__device__ __forceinline__ void count_half(const Half& h, int z,
                                           const Classes& k, int c, int& oc,
                                           int& og, int& n, int& up) {
  const uint32_t w[4] = {h.v.x, h.v.y, h.v.z, h.v.w};
  const uint32_t flip = h.down ? 0xFFFFFFFFu : 0u;
  uint32_t sc[4], sg[4], nn[4], uu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t ma = top_bases(h.a - 16 * i);
    const uint32_t side = ma ^ flip;
    const uint32_t range = top_bases(z - 16 * i) & ~ma;
    const uint32_t eq = is_c(w[i], k), gt = above_c(w[i], k);
    sc[i] = eq & side;
    sg[i] = gt & side;
    nn[i] = eq & range;
    uu[i] = gt & range;
  }
  int cs = popc4(sc[0], sc[1], sc[2], sc[3]);
  int gs = popc4(sg[0], sg[1], sg[2], sg[3]);
  if (h.upper && !h.down) {
    const uint32_t l[4] = {h.lo.x, h.lo.y, h.lo.z, h.lo.w};
    cs += popc4(is_c(l[0], k), is_c(l[1], k), is_c(l[2], k), is_c(l[3], k));
    gs += popc4(above_c(l[0], k), above_c(l[1], k), above_c(l[2], k),
                above_c(l[3], k));
  }
  oc = pick(h.ck.x, h.ck.y, h.ck.z, h.ck.w, c) + (h.down ? -cs : cs);
  og = above_ck(h.ck, c) + (h.down ? -gs : gs);
  n = popc4(nn[0], nn[1], nn[2], nn[3]);
  up = popc4(uu[0], uu[1], uu[2], uu[3]);
}

// bwa bwt_extend (is_back=1) of the interval [x, x + s) by base c: returns
// the new size; occ = c's occurrences in conceptual rows [0, x), up = the
// bases above c in the interval (the sentinel row not counted).  One
// half-block when stored rows [r1, r2) lie in r1's half (or run from its
// upper half to the block's end); else a lookup at each end, both loaded
// before either is counted
__device__ __forceinline__ int extend(const Fmd& f, int x, int s, int c,
                                      int& occ, int& up) {
  const int r1 = stored_row(f, x), r2 = stored_row(f, x + s);
  const int e = r2 - ((r1 >> 7) << 7);
  const Classes k = classes_of(c);
  const Half p = load_half(f, r1, e);
  int n, og;
  if (e <= (p.upper ? 128 : 64)) {
    count_half(p, e - (p.upper ? 64 : 0), k, c, occ, og, n, up);
  } else {
    const Half q = load_half(f, r2, r2 & 127);
    int o2, g2;
    count_half(p, p.a, k, c, occ, og, n, up);
    count_half(q, q.a, k, c, o2, g2, n, up);
    n = o2 - occ;
    up = g2 - og;
  }
  if (c == 0) up = r2 - r1 - n;
  return n;
}

__global__ void fm_smem_kernel(const uint8_t* __restrict__ reads,
               const int* __restrict__ lengths, int B, int L,
               const int* __restrict__ starts, int G, Fmd fp,
               int* __restrict__ qbeg_o, int* __restrict__ qend_o,
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
  int qbeg = p;
  if (alive0) {
    // x is the rank a step extends, y its mirror: a forward step appends
    // read[p + j] by backward-extending the mirror interval (l, k) by the
    // complement, a backward step prepends read[p - j] to (k, l)
    int x = l, y = k, j = 1;
    bool fwd = true;
    const int back0 = base(p - 1);
    c = base(p + 1);
    bool go = c < 4 && 1 < L;
    for (;;) {
      if (!go && fwd) {  // forward is over: turn to the backward phase
        fwd = false;
        const int t = x;
        x = y;
        y = t;
        j = 1;
        c = back0;
        go = c < 4;
      }
      if (!go) break;
      const int next = base(fwd ? p + j + 1 : p - j - 1);
      const int cc = fwd ? 3 - c : c;
      int occ, up;
      const int ns = extend(f, x, s, cc, occ, up);
      go = ns > 0;
      if (go) {
        y += (f.primary >= x && f.primary < x + s ? 1 : 0) + up;
        x = cnt(f, cc) + occ;
        s = ns;
        if (fwd) qend = p + j + 1; else qbeg = p - j;
        ++j;
        c = next;
        go = c < 4 && (fwd ? j < L : j <= L);
      }
    }
    k = x;
  }
  qbeg_o[i] = qbeg;
  qend_o[i] = qend;
  k_o[i] = k;
  s_o[i] = s;
  alive_o[i] = alive0 ? 1 : 0;
}

// ------------------------------------------------------------ the walk

struct Walk {
  const int* __restrict__ count;     // (4,) C'[c]
  const int4* __restrict__ rec;      // (n_blocks + 1, 4): checkpoint, lower
                                     // half, upper half, mark words
  int full_blocks, primary, seq_len;
  int c0, c1, c2, c3;
};

// one LF step's loads, from stored row kk's record
struct StepLoad {
  int4 ck;
  uint4 half;
  uint32_t mark;
};

__device__ __forceinline__ int stored_of(const Walk& f, int r) {
  return r - (r > f.primary ? 1 : 0);
}

__device__ __forceinline__ StepLoad step_load(const Walk& f, int kk) {
  const int4* row = f.rec + 4 * (size_t)(kk >> 7);
  const int w = kk & 127;
  StepLoad l;
  l.ck = __ldg(row);
  l.half = __ldg(reinterpret_cast<const uint4*>(row + 1 + (w >> 6)));
  l.mark = __ldg(reinterpret_cast<const uint32_t*>(row + 3) + (w >> 5));
  return l;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// LF of stored row kk: C'[c] + c's occurrences in stored rows [0, kk), c
// the row's base; the upper half counts [64, w) up from the checkpoint,
// the lower half [w, m) down to it (m = 64, or the rows a partial last
// block holds below 64)
__device__ __forceinline__ int lf_step(const Walk& f, int kk,
                                       const StepLoad& l) {
  const int blk = kk >> 7, w = kk & 127, a = w & 63;
  const int c = (word_of(l.half, a >> 4) >> (30 - 2 * (a & 15))) & 3;
  const Classes k = classes_of(c);
  const bool up = w >= 64;
  const int m = blk < f.full_blocks ? 64 : min(64, f.seq_len & 127);
  const int lo = up ? 0 : a, hi = up ? a : m;
  uint32_t bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t range = top_bases(hi - 16 * i) & ~top_bases(lo - 16 * i);
    bits[i] = is_c(word_of(l.half, i), k) & range;
  }
  const int n = popc4(bits[0], bits[1], bits[2], bits[3]);
  return cnt(f, c) + pick(l.ck.x, l.ck.y, l.ck.z, l.ck.w, c) + (up ? n : -n);
}

__global__ void __launch_bounds__(128) fm_sa_walk_kernel(
    const int* __restrict__ ranks, int n, Walk fp,
    const uint32_t* __restrict__ sa_mark, const int* __restrict__ sa_ckpt,
    const int* __restrict__ sa_vals, int n_vals, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Walk f = fp;
  f.c0 = __ldg(f.count);
  f.c1 = __ldg(f.count + 1);
  f.c2 = __ldg(f.count + 2);
  f.c3 = __ldg(f.count + 3);
  int r = __ldg(ranks + i);
  int steps = 0;
  for (int it = 0; it < 32; ++it) {
    const int kk = stored_of(f, r);
    // every load before any test (the sentinel rank's kk may be seq_len,
    // in the records' zero pad record, unread)
    const StepLoad l = step_load(f, kk);
    if (r == f.primary || ((l.mark >> (kk & 31)) & 1u)) break;
    r = lf_step(f, kk, l);
    ++steps;
  }
  const uint32_t w = __ldg(sa_mark + (r >> 5));
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
  f.bwt4 = reinterpret_cast<const uint4*>(bwt);
  f.n_blocks = n_blocks;
  f.full_blocks = seq_len >> 7;
  f.primary = primary;
  f.seq_len = seq_len;
  f.c0 = f.c1 = f.c2 = f.c3 = 0;
  return f;
}

// the vector loads need 16-byte rows
bool rows_aligned(const int* occ, const uint32_t* bwt) {
  return ((reinterpret_cast<uintptr_t>(occ) |
           reinterpret_cast<uintptr_t>(bwt)) & 15) == 0;
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
  if (!rows_aligned(occ, bwt)) return (int)cudaErrorMisalignedAddress;
  const int threads = 128;
  fm_smem_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      reads, lengths, B, L, starts, G,
      make_fmd(count, occ, bwt, n_blocks, primary, seq_len), qbeg, qend, k, s,
      alive0);
  return (int)cudaGetLastError();
}

// rec: the walk records (16-byte aligned)
extern "C" int ssq_fm_sa_walk(const int* ranks, int n, const int* count,
                              const int* rec, int primary, int seq_len,
                              const uint32_t* sa_mark, const int* sa_ckpt,
                              const int* sa_vals, int n_vals, int* out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(rec) & 15)
    return (int)cudaErrorMisalignedAddress;
  Walk f;
  f.count = count;
  f.rec = reinterpret_cast<const int4*>(rec);
  f.full_blocks = seq_len >> 7;
  f.primary = primary;
  f.seq_len = seq_len;
  f.c0 = f.c1 = f.c2 = f.c3 = 0;
  const int threads = 128;
  fm_sa_walk_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      ranks, n, f, sa_mark, sa_ckpt, sa_vals, n_vals, out);
  return (int)cudaGetLastError();
}
