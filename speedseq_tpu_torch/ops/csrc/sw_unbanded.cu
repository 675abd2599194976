// Unbanded local affine-gap Smith-Waterman for Hopper (sm_90a), behind a
// plain C interface for ctypes: the score-only scan and the DP with
// traceback.
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
//     or past qlen change nothing.
//
// Design: one kernel (sw_unbanded_scan_kernel<R>) behind both entry
// points, a column wavefront with the query rows in registers.  Thread t
// of a warp owns R consecutive query rows of a stripe of 32 R rows, with
// their query codes.  The warp sweeps the window 4 columns a step: at step
// s thread t works on columns 4 (s - t) .. 4 (s - t) + 3 (Lr / 4 + 31
// steps; a block before the window is skipped, so the state there keeps
// its boundary values H = 0, F = NEG).  A step takes from thread t - 1,
// through shared memory (two int4 slots a thread, double-buffered, one
// __syncwarp a step), the H of the row above at those columns and the V
// (vertical gap) of its first row; keeps the row above's H left of the
// block from the step before (the diagonal); reads the 4 window codes as
// one int4 from a copy of the window in shared memory; and computes its
// R x 4 cells in anti-diagonal order.  Nothing is reduced across the warp
// inside a step:
//   - deletions are horizontal, so they stay in the thread: the twin's
//     F(j) = max over j' < j of Ht(j') - o - e (j - j') is the recurrence
//     F(j) = max(F(j - 1) - e, Ht(j - 1) - o - e) with F(0) = NEG, kept
//     as F + e j.  The recurrence adds the term NEG - e j, below 0 <= Ht
//     at every column, and the twin's key filter (keys below 0 count as
//     NEG) drops no maximum, since column 0's key is >= 0: H = max(Ht, F)
//     is the twin's for any o, e.  With o >= 0 the carry may read H for
//     Ht (H - o - e <= Ht - o - e or <= F - e), which saves computing Ht;
//   - V of row u + 1 is max(V(u) - e, Y(u) - o - e) with Y = max(diag, F,
//     0), H = max(V, Y): exact for o >= 0 (V - o - e <= V - e), so the
//     chain down a column is one max-of-sum a row (V kept as V + e u);
//   - the last column block runs past the window when Lr is not a
//     multiple of 4: its diagonal steps score NEG, so those cells get
//     their values from real cells through gaps only and stay at or below
//     the row max of the real cells (a real cell of the row is at least
//     the gap's source less its vertical gap) when o, e >= 0; their
//     negative key columns lose every tie.  The wrapper raises for o < 0
//     or e < 0 on cuda;
//   - the best cell: each row keeps max(h Lr + Lr - 1 - j), its max and
//     first maximal column in one int32 (exact where the twin's key
//     (Ht + e j) Lr + j is, ops/sw_unbanded.py:max_width); after the
//     sweep one reduction over the rows, largest max then first row, in a
//     64-bit key gives (score, qend, rend) as the twin's row-order scan
//     with a strictly larger test does; the thread holding row qlen - 1
//     gives (gscore, grend).
// Rows at or past qlen run on (they feed only rows below them) and are
// left out of the reduction.  The stripe loop is instantiated for lanes
// with and without a query code >= 4 before qlen (without one, a cell's
// score needs no mask) and for Lr a multiple of 4 or not.
//
// Queries of more than 32 R rows are cut into stripes: a stripe's bottom
// row (the H of its last row and the V of the next, 8 bytes a column)
// goes to a buffer that the next stripe's thread 0 reads one step ahead.
// A block runs `warps` warps, warp w the stripes w, w + warps, ...: each
// stripe ~40 steps behind the one above it, signalled by a progress
// counter a warp in shared memory (every 32 columns).  The buffers
// (warps x Lr x 8 bytes) live in shared memory, or in a device scratch
// the wrapper allocates where a block cannot hold them.  Layouts
// (ops/sw_unbanded.py:scan_layout): one warp, one stripe, R the fewest
// rows a thread up to 256 query rows (R = 5 at var's 150), else R = 8 on
// up to 8 warps.
//
// What bounds the scan on this card: int32 instructions, 8 a cell
// (ops/sw_unbanded.py:OPS_PER_CELL) against 132 SMs x 128 lanes x clock;
// a call reads (Lq + Lr + 1) x 4 bytes and writes 20 bytes an alignment.
// One alignment's block stays on one SM, and a call of ~90-300
// alignments leaves most schedulers idle, so a warp's step sets the pace:
// ~7 ALU-pipe instructions a cell (the ALU pipe takes a warp instruction
// every 2 clocks) and the step's chain (the hand-off, then R + 3 cells
// down the block's anti-diagonals).  The max-of-sum steps are left to the
// compiler (it emits VIADDMNMX): DPX intrinsics measured slower here.
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

// ---- the haplotype scan: a column wavefront, query rows in registers ----

constexpr int SCAN_MAX_WARPS = 8;
constexpr int SCAN_COLS = 4;          // columns a thread a step (an int4)
constexpr int SCAN_HEAD_INTS = 32;    // progress, the warps' best, (gs, gr)
constexpr int SCAN_SLOT_INTS = 512;   // a warp's hand-off: 2 x 32 x (H, V)

// Spin (all lanes) until a stripe's progress counter reaches `need`; the
// fence orders the buffer reads after it.  A counter that never gets
// there (a fault) traps after ~2^26 polls instead of holding the card.
__device__ __forceinline__ void wait_progress(const volatile int* flag,
                                              int need) {
  for (int spin = 0; *flag < need; ++spin) {
    if (spin > (1 << 26)) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared memory of a block: the head, the hand-off slots, the window's
// codes (4 or more as 4), then the stripe buffers where they fit
// (scan_buffer_ints of them, else a device scratch).
__host__ __device__ inline long scan_fixed_ints(int Lr, int warps) {
  return SCAN_HEAD_INTS + (long)SCAN_SLOT_INTS * warps + round4(Lr);
}
__host__ __device__ inline long scan_buffer_ints(int Lq, int Lr, int R,
                                                 int warps) {
  return Lq > 32 * R ? 2L * warps * round4(Lr) : 0;
}

// A block's shared state and arguments, for the stripe loop.
struct ScanBlock {
  const int* q;              // this lane's query
  int Lq, Lr, Lp, rows, nstripes, warps;
  Scoring p;
  volatile int* progress;    // a warp's stripe progress
  int4* slot;                // this warp's hand-off slots
  const int4* win4;          // the window's codes, 4 a column block
  int* bufH;                 // stripe buffers, H then V
  int* bufV;
  int* gsh;                  // (gscore, grend)
  int ql;
};

// This warp's stripes: returns the best (max, first row, column) key of
// their rows.  NROW: some query row holds a code >= 4 (it scores -1
// against every column); PART: Lr is not a multiple of 4, so the last
// column block runs past the window.
template <int R, bool NROW, bool PART>
__device__ __forceinline__ unsigned long long scan_stripes(
    const ScanBlock& b, int t, int w) {
  constexpr int SR = 32 * R;
  constexpr int C = SCAN_COLS;
  const int Lq = b.Lq, Lr = b.Lr, Lp = b.Lp, rows = b.rows,
            nstripes = b.nstripes, warps = b.warps;
  const Scoring p = b.p;
  const int* q = b.q;
  volatile int* progress = b.progress;
  int4* slot = b.slot;
  const int4* win4 = b.win4;
  int* bufH = b.bufH;
  int* bufV = b.bufV;
  int* gsh = b.gsh;
  const int ql = b.ql;
  const int nsteps = Lp / C + 31;
  const int e = p.ext, oe = p.open + p.ext;
  const int top_v = max(NEG - e, -oe);   // V of the query's first row
  const int4 top_v4 = make_int4(top_v, top_v, top_v, top_v);
  const int4 zero4 = make_int4(0, 0, 0, 0);
  unsigned long long best = 0;
  for (int k = w; k < nstripes; k += warps) {
    const int i0 = k * SR + t * R;        // this thread's first row
    int qk[R], qm[R], H[R], F[R], key[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int c = i0 + u < Lq ? q[i0 + u] : 4;
      qk[u] = c < 4 ? c : 5;   // 5 equals no window code (those are <= 4)
      qm[u] = c < 4 ? 0 : -1;  // -1 | anything = -1: an N row scores -1
      H[u] = 0;                // H at the column left of the block
      F[u] = NEG;              // F + e j
      key[u] = -1;
    }
    const bool src = k > 0;                 // the rows above: a stripe's
    const bool dst = k + 1 < nstripes;      // bottom row is read below
    const int ws = src ? (k - 1) % warps : 0;
    const int sbase = src ? (k - 1) / warps * Lr : 0;
    const int4* sH = reinterpret_cast<const int4*>(bufH + (long)ws * Lp);
    const int4* sV = reinterpret_cast<const int4*>(bufV + (long)ws * Lp);
    int4* dH = reinterpret_cast<int4*>(bufH + (long)w * Lp);
    int4* dV = reinterpret_cast<int4*>(bufV + (long)w * Lp);
    const int dbase = k / warps * Lr;
    // thread 0's rows above for the next step: the boundary, or the
    // stripe above's bottom row
    int4 nH = zero4, nV = top_v4;
    if (src) {
      wait_progress(progress + ws, sbase + min(32, Lr));
      nH = sH[0];
      nV = sV[0];
    }
    int upHd = 0;                  // H of the row above left of the block
    int4 botH = zero4, botV = top_v4;   // the last row's H, the next row's V
    __syncwarp();
    slot[64 + 2 * t] = botH;       // "step -1", parity 1
    slot[65 + 2 * t] = botV;
    int4 rkn = win4[0];
    for (int s = 0; s < nsteps; ++s) {
      const int j0 = C * (s - t);           // this step's first column
      __syncwarp();
      const int4* from = slot + 64 * ((s + 1) & 1) + 2 * ((t + 31) & 31);
      int4 uH = from[0], uV = from[1];
      if (t == 0) {
        uH = nH;
        uV = nV;
      }
      const int4 rk4 = rkn;
      rkn = win4[(unsigned)(j0 + C) < (unsigned)Lp ? (j0 >> 2) + 1 : 0];
      if (src) {                            // the next step's, for thread 0
        const int c1 = C * (s + 1);
        if (c1 < Lp) {
          if ((c1 & 31) == 0)
            wait_progress(progress + ws, sbase + min(c1 + 32, Lr));
          nH = sH[c1 >> 2];
          nV = sV[c1 >> 2];
        }
      }
      if (j0 >= 0 && j0 < Lr) {
        const int rk[C] = {rk4.x, rk4.y, rk4.z, rk4.w};
        int hup[C] = {uH.x, uH.y, uH.z, uH.w};   // the row above's H
        int v[C] = {uV.x, uV.y, uV.z, uV.w};     // V of row u, + e u
        int misj[C], off[C], ej[C], cF[C], ck[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          misj[c] = rk[c] < 4 ? -p.mis : -1;
          off[c] = PART && j >= Lr ? NEG : 0;   // none past the window
          ej[c] = e * j;
          cF[c] = ej[c] - p.open;           // F + e (j + 1) from H
          ck[c] = Lr - 1 - j;               // the row key's column part
        }
        // the R x C cells in anti-diagonal order: the cells of one
        // anti-diagonal depend on none of each other, so the in-order
        // issue finds independent work between a cell's dependent steps
        int hh[R][C];             // this step's H
#pragma unroll
        for (int d = 0; d < R + C - 1; ++d) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const int c = d - u;
            if (c < 0 || c >= C) continue;
            const int hd = c ? (u ? hh[u - 1][c - 1] : hup[c - 1])
                             : (u ? H[u - 1] : upHd);
            const int sub = qk[u] == rk[c] ? p.match
                                           : NROW ? misj[c] | qm[u] : misj[c];
            const int y = max(max(hd + sub + off[c], F[u] - ej[c]), 0);
            const int h = max(v[c] - e * u, y);
            v[c] = max(y + (e * (u + 1) - oe), v[c]);
            F[u] = max(h + cF[c], F[u]);
            key[u] = max(key[u], h * Lr + ck[c]);
            hh[u][c] = h;
          }
        }
#pragma unroll
        for (int u = 0; u < R; ++u) H[u] = hh[u][C - 1];
        botH = make_int4(hh[R - 1][0], hh[R - 1][1], hh[R - 1][2],
                         hh[R - 1][3]);
        botV = make_int4(v[0] - e * R, v[1] - e * R, v[2] - e * R,
                         v[3] - e * R);
        if (dst && t == 31) {
          dH[j0 >> 2] = botH;
          dV[j0 >> 2] = botV;
          const int done = min(j0 + C, Lr);
          if ((done & 31) == 0 || done == Lr) {
            __threadfence_block();
            progress[w] = dbase + done;
          }
        }
      }
      upHd = uH.w;
      slot[64 * (s & 1) + 2 * t] = botH;
      slot[64 * (s & 1) + 2 * t + 1] = botV;
    }
    // this stripe's rows: the largest max, then the first row, in a key
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + u;
      if (i < rows) {
        const int rm = key[u] / Lr, col = Lr - 1 - key[u] % Lr;
        best = max(best, ((unsigned long long)rm << 32) |
                             ((unsigned long long)(65535 - i) << 16) | col);
        if (i == ql - 1) {
          gsh[0] = rm;
          gsh[1] = col + 1;
        }
      }
    }
  }
  return best;
}

template <int R>
__global__ void __launch_bounds__(32 * SCAN_MAX_WARPS)
    sw_unbanded_scan_kernel(const int* __restrict__ query,
                            const int* __restrict__ qlen,
                            const int* __restrict__ ref, int n, int Lq,
                            int Lr, int warps, Scoring p,
                            int* __restrict__ out, long stride,
                            int* __restrict__ scratch) {
  static_assert(SCAN_COLS == 4, "a step's columns travel as one int4");
  extern __shared__ int4 scan_smem4[];
  int* scan_smem = reinterpret_cast<int*>(scan_smem4);
  const int lane = blockIdx.x;
  if (lane >= n) return;
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  ScanBlock b;
  b.Lq = Lq;
  b.Lr = Lr;
  b.Lp = round4(Lr);
  b.warps = warps;
  b.p = p;
  b.progress = scan_smem;
  unsigned long long* best_w =
      reinterpret_cast<unsigned long long*>(scan_smem + SCAN_MAX_WARPS);
  b.gsh = scan_smem + 3 * SCAN_MAX_WARPS;
  // this warp's hand-off slots: [parity][thread][H, V], an int4 each
  b.slot = reinterpret_cast<int4*>(scan_smem + SCAN_HEAD_INTS +
                                   SCAN_SLOT_INTS * w);
  int* win = scan_smem + SCAN_HEAD_INTS + SCAN_SLOT_INTS * warps;
  b.win4 = reinterpret_cast<const int4*>(win);
  // stripe buffers: warp w's bottom rows, H then V, Lp columns each
  b.bufH = scratch ? scratch + (long)lane * 2 * warps * b.Lp : win + b.Lp;
  b.bufV = b.bufH + (long)warps * b.Lp;
  b.q = query + (long)lane * Lq;
  const int* r = ref + (long)lane * Lr;
  b.ql = qlen[lane];
  b.rows = min(b.ql, Lq);
  b.nstripes = b.rows > 0 ? (b.rows + 32 * R - 1) / (32 * R) : 0;
  if (threadIdx.x < SCAN_MAX_WARPS) b.progress[threadIdx.x] = 0;
  for (int j = threadIdx.x; j < b.Lp; j += blockDim.x) {
    const int c = j < Lr ? r[j] : 4;
    win[j] = c < 4 ? c : 4;
  }
  int nrow = 0;                   // a query row of a code >= 4
  for (int i = threadIdx.x; i < b.rows; i += blockDim.x)
    nrow |= b.q[i] >= 4;
  nrow = __syncthreads_or(nrow);
  unsigned long long best;
  if (Lr & 3)
    best = nrow ? scan_stripes<R, true, true>(b, t, w)
                : scan_stripes<R, false, true>(b, t, w);
  else
    best = nrow ? scan_stripes<R, true, false>(b, t, w)
                : scan_stripes<R, false, false>(b, t, w);
  const int* gsh = b.gsh;
  const int ql = b.ql;
#pragma unroll
  for (int d = 16; d; d >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, d));
  if (t == 0) best_w[w] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int x = 1; x < warps; ++x) best = max(best, best_w[x]);
    const int bs = (int)(best >> 32);
    const bool g = ql >= 1 && ql <= Lq;
    out[lane] = bs;
    out[stride + lane] = bs > 0 ? 65536 - (int)((best >> 16) & 0xffff) : 0;
    out[2 * stride + lane] = bs > 0 ? (int)(best & 0xffff) + 1 : 0;
    out[3 * stride + lane] = g ? gsh[0] : 0;
    out[4 * stride + lane] = g ? gsh[1] : 0;
  }
}

template <int R>
int launch_scan(const void* query, const void* qlen, const void* ref, int n,
                int Lq, int Lr, int warps, Scoring p, void* out, long stride,
                void* scratch, cudaStream_t stream) {
  size_t smem = sizeof(int) * (scan_fixed_ints(Lr, warps) +
                               (scratch ? 0 : scan_buffer_ints(Lq, Lr, R,
                                                               warps)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_unbanded_scan_kernel<R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_unbanded_scan_kernel<R><<<n, 32 * warps, smem, stream>>>(
      (const int*)query, (const int*)qlen, (const int*)ref, n, Lq, Lr, warps,
      p, (int*)out, stride, (int*)scratch);
  return (int)cudaGetLastError();
}

int launch_scan_rows(int R, const void* query, const void* qlen,
                     const void* ref, int n, int Lq, int Lr, int warps,
                     Scoring p, void* out, long stride, void* scratch,
                     cudaStream_t s) {
#define SSQ_SCAN(X)                                                       \
  if (R == X)                                                             \
    return launch_scan<X>(query, qlen, ref, n, Lq, Lr, warps, p, out,     \
                          stride, scratch, s);
  SSQ_SCAN(1)
  SSQ_SCAN(2)
  SSQ_SCAN(3)
  SSQ_SCAN(4)
  SSQ_SCAN(5)
  SSQ_SCAN(6)
  SSQ_SCAN(8)
#undef SSQ_SCAN
  return (int)cudaErrorInvalidValue;
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
// gscore, grend.  Needs 0 <= Lq <= Lr <= 1024, Lr >= 1 and gap open >= 0;
// the layout is ops/sw_unbanded.py:scan_layout's (the stripe buffers, at
// most 32 KB, in shared memory).  Returns cudaGetLastError() after the
// launch.
int ssq_sw_unbanded_score(const void* query, const void* qlen,
                          const void* ref, int n, int Lq, int Lr, int p_match,
                          int p_mis, int p_open, int p_ext, void* out,
                          long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr < 1 || Lr > MAX_LR || p_open < 0 || p_ext < 0)
    return (int)cudaErrorInvalidValue;
  // one warp and one stripe up to 256 rows, else stripes of 256 rows on
  // up to 8 warps (at most 4 here)
  int R = 8, warps = min((Lq + 255) / 256, SCAN_MAX_WARPS);
  if (Lq <= 256) {
    R = max((Lq + 31) / 32, 1);
    R = R == 7 ? 8 : R;
    warps = 1;
  }
  return launch_scan_rows(R, query, qlen, ref, n, Lq, Lr, warps,
                          Scoring{p_match, p_mis, p_open, p_ext}, out,
                          out_stride, nullptr, (cudaStream_t)stream);
}

// The same scan at any width up to the wrapper's max_width, with the
// layout given: R query rows a thread (1-6 or 8) and `warps`
// (1-8) warps a block.  scratch: NULL to keep the stripe buffers in shared
// memory, else a device buffer of 2 x warps x Lr int32 a lane (needed
// only where Lq > 32 R).  Needs 0 <= Lq <= Lr, Lr >= 1, gap open >= 0.
int ssq_sw_unbanded_score_wide(const void* query, const void* qlen,
                               const void* ref, int n, int Lq, int Lr,
                               int R, int warps, int p_match, int p_mis,
                               int p_open, int p_ext, void* out,
                               long out_stride, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (Lq < 0 || Lq > Lr || Lr < 1 || warps < 1 || warps > SCAN_MAX_WARPS ||
      p_open < 0 || p_ext < 0)
    return (int)cudaErrorInvalidValue;
  return launch_scan_rows(R, query, qlen, ref, n, Lq, Lr, warps,
                          Scoring{p_match, p_mis, p_open, p_ext}, out,
                          out_stride, scratch, (cudaStream_t)stream);
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
