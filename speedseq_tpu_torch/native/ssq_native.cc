// speedseq-tpu native runtime: htslib-equivalent host-side hot paths.
//
// The reference pipeline's host-side native code is htslib's BGZF layer
// (src/samtools-1.3.1/htslib-1.3.1/bgzf.c: block deflate, the bgzf_mt
// thread-pool writer at bgzf.c:781-812) and the BAM record codec
// (src/.../sam.c:407,443 bam_read1/bam_write1 over the bam1_t layout,
// htslib/sam.h:148-181).  This library re-implements those behaviors as a
// C ABI shared object consumed via ctypes (speedseq_tpu_torch/native/__init__.py).
// Byte-exactness: deflate uses zlib raw streams at the same level as the
// formats layer's one-block Python writer, so outputs are bit-identical.
//
// NOT a copy of htslib: fresh implementation against the format contract
// documented in SURVEY.md §2.2 #1.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr int64_t kBlockSize = 0xff00;  // BGZF_BLOCK_SIZE, htslib/bgzf.h:43
constexpr int64_t kMaxCBlock = 0x10000; // compressed block hard cap (u16 BSIZE)
constexpr int kHeaderLen = 12;          // gzip hdr + XLEN
constexpr int kFixedOverhead = 18 + 8;  // full header (incl BC/BSIZE) + CRC/ISIZE

const uint8_t kBgzfHeader[18] = {
    0x1f, 0x8b, 0x08, 0x04,             // magic, CM=deflate, FLG=FEXTRA
    0x00, 0x00, 0x00, 0x00,             // MTIME
    0x00, 0xff,                         // XFL, OS
    0x06, 0x00,                         // XLEN = 6
    'B', 'C', 0x02, 0x00,               // subfield BC, len 2
    0x00, 0x00,                         // BSIZE-1 placeholder
};

const uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
};

// Minimal run-to-completion parallel-for: spawn min(nthreads, njobs) workers
// pulling block indices off an atomic counter.  Threads are cheap relative
// to multi-MB deflate batches; no persistent pool state to manage across
// ctypes calls.
void parallel_for(int64_t n, int nthreads, const std::function<void(int64_t)>& fn) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  int workers = static_cast<int>(n < nthreads ? n : nthreads);
  if (workers == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> ts;
  ts.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    ts.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& t : ts) t.join();
}

// Deflate one payload into a complete BGZF block at dst; returns block size
// or -1.  Matches bgzf_compress (bgzf.c): raw deflate, CRC32 + ISIZE footer.
int64_t compress_block(const uint8_t* src, int64_t n, int level, uint8_t* dst) {
  if (n > kBlockSize) return -1;
  std::memcpy(dst, kBgzfHeader, sizeof(kBgzfHeader));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = dst + sizeof(kBgzfHeader);
  zs.avail_out = static_cast<uInt>(kMaxCBlock - sizeof(kBgzfHeader) - 8);
  int ret = deflate(&zs, Z_FINISH);
  int64_t clen = static_cast<int64_t>(zs.total_out);
  deflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  int64_t bsize = clen + kFixedOverhead;
  if (bsize > kMaxCBlock) return -1;
  dst[16] = static_cast<uint8_t>((bsize - 1) & 0xff);
  dst[17] = static_cast<uint8_t>(((bsize - 1) >> 8) & 0xff);
  uint32_t crc = static_cast<uint32_t>(crc32(0L, src, static_cast<uInt>(n)));
  uint8_t* foot = dst + sizeof(kBgzfHeader) + clen;
  uint32_t isize = static_cast<uint32_t>(n);
  std::memcpy(foot, &crc, 4);
  std::memcpy(foot + 4, &isize, 4);
  return bsize;
}

// Parse one BGZF block header at src; returns BSIZE (total compressed block
// length) or -1 on malformed input.
int64_t block_bsize(const uint8_t* src, int64_t avail) {
  if (avail < 18) return -1;
  if (src[0] != 0x1f || src[1] != 0x8b || src[2] != 0x08 || src[3] != 0x04)
    return -1;
  int xlen = src[10] | (src[11] << 8);
  if (avail < kHeaderLen + xlen + 8) return -1;
  int off = kHeaderLen;
  int end = kHeaderLen + xlen;
  while (off + 4 <= end) {
    int si1 = src[off], si2 = src[off + 1];
    int slen = src[off + 2] | (src[off + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2 && off + 6 <= end)
      return (src[off + 4] | (src[off + 5] << 8)) + 1;
    off += 4 + slen;
  }
  return -1;
}

}  // namespace

extern "C" {

int ssq_version() { return 1; }

// Upper bound on BGZF output size for n input bytes (incl. EOF marker).
int64_t ssq_bgzf_compress_bound(int64_t n) {
  int64_t nblocks = (n + kBlockSize - 1) / kBlockSize;
  if (nblocks == 0) nblocks = 1;
  // worst case per block: stored deflate ~ n + n/16k*5 + 64; cap at kMaxCBlock
  return nblocks * kMaxCBlock + sizeof(kBgzfEof);
}

// Multithreaded BGZF compression of a whole buffer (bgzf_mt equivalent,
// bgzf.c:781-812).  Output is byte-identical to sequential zlib compression
// of the same 65280-byte block split.  Returns bytes written or -1.
int64_t ssq_bgzf_compress(const uint8_t* src, int64_t n, int level,
                          int nthreads, uint8_t* dst, int64_t dst_cap,
                          int add_eof) {
  int64_t nblocks = (n + kBlockSize - 1) / kBlockSize;
  std::vector<std::vector<uint8_t>> blocks(static_cast<size_t>(nblocks));
  std::atomic<bool> failed(false);
  parallel_for(nblocks, nthreads, [&](int64_t i) {
    int64_t off = i * kBlockSize;
    int64_t len = (off + kBlockSize <= n) ? kBlockSize : (n - off);
    blocks[i].resize(kMaxCBlock);
    int64_t bs = compress_block(src + off, len, level, blocks[i].data());
    if (bs < 0) { failed.store(true); return; }
    blocks[i].resize(static_cast<size_t>(bs));
  });
  if (failed.load()) return -1;
  int64_t total = 0;
  for (auto& b : blocks) total += static_cast<int64_t>(b.size());
  if (add_eof) total += sizeof(kBgzfEof);
  if (total > dst_cap) return -1;
  uint8_t* p = dst;
  for (auto& b : blocks) {
    std::memcpy(p, b.data(), b.size());
    p += b.size();
  }
  if (add_eof) {
    std::memcpy(p, kBgzfEof, sizeof(kBgzfEof));
    p += sizeof(kBgzfEof);
  }
  return p - dst;
}

// Scan a BGZF byte buffer: returns block count, fills (coffset, bsize, isize)
// triples for up to max_blocks blocks.  Returns -1 on malformed input,
// -(count) - 2 if max_blocks too small (caller re-allocates).
int64_t ssq_bgzf_scan(const uint8_t* src, int64_t n, int64_t* coffsets,
                      int64_t* bsizes, int64_t* isizes, int64_t max_blocks) {
  int64_t off = 0, cnt = 0;
  while (off < n) {
    int64_t bs = block_bsize(src + off, n - off);
    if (bs < 0 || off + bs > n) return -1;
    if (cnt < max_blocks) {
      coffsets[cnt] = off;
      bsizes[cnt] = bs;
      uint32_t isize;
      std::memcpy(&isize, src + off + bs - 4, 4);
      isizes[cnt] = isize;
    }
    ++cnt;
    off += bs;
  }
  if (cnt > max_blocks) return -cnt - 2;
  return cnt;
}

// Parallel inflate of a whole BGZF buffer (after ssq_bgzf_scan).  uoffsets
// holds the running exclusive prefix sum of isizes (len nblocks).  Returns
// total uncompressed bytes or -1.
int64_t ssq_bgzf_decompress(const uint8_t* src, const int64_t* coffsets,
                            const int64_t* bsizes, const int64_t* uoffsets,
                            const int64_t* isizes, int64_t nblocks,
                            int nthreads, uint8_t* dst, int64_t dst_cap) {
  int64_t total = nblocks ? uoffsets[nblocks - 1] + isizes[nblocks - 1] : 0;
  if (total > dst_cap) return -1;
  std::atomic<bool> failed(false);
  parallel_for(nblocks, nthreads, [&](int64_t i) {
    const uint8_t* blk = src + coffsets[i];
    int64_t bs = bsizes[i];
    int xlen = blk[10] | (blk[11] << 8);
    const uint8_t* cdata = blk + kHeaderLen + xlen;
    int64_t clen = bs - kHeaderLen - xlen - 8;
    uint32_t want_crc, want_isize;
    std::memcpy(&want_crc, blk + bs - 8, 4);
    std::memcpy(&want_isize, blk + bs - 4, 4);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) { failed.store(true); return; }
    zs.next_in = const_cast<Bytef*>(cdata);
    zs.avail_in = static_cast<uInt>(clen);
    zs.next_out = dst + uoffsets[i];
    zs.avail_out = static_cast<uInt>(want_isize);
    int ret = inflate(&zs, Z_FINISH);
    uint64_t got = zs.total_out;
    inflateEnd(&zs);
    if ((ret != Z_STREAM_END && !(ret == Z_BUF_ERROR && want_isize == 0)) ||
        got != want_isize) {
      failed.store(true);
      return;
    }
    uint32_t crc = static_cast<uint32_t>(
        crc32(0L, dst + uoffsets[i], static_cast<uInt>(want_isize)));
    if (crc != want_crc) failed.store(true);
  });
  return failed.load() ? -1 : total;
}

// ---------------------------------------------------------------------------
// BAM record batch codec (bam1_t layout, htslib/sam.h:148-181).
// Columnar in, concatenated block_size-prefixed records out.
// ---------------------------------------------------------------------------

// reg2bin, BAI 14/5 binning (SURVEY.md §2.2 #1; hts.c:1622 semantics).
static inline int reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return static_cast<int>(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return static_cast<int>(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return static_cast<int>(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return static_cast<int>(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return static_cast<int>(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

// 4-bit nucleotide codes indexed by ASCII (seq_nt16_table semantics).
static uint8_t nt16_for_ascii(uint8_t c) {
  switch (c) {
    case '=': return 0;
    case 'A': case 'a': return 1;  case 'C': case 'c': return 2;
    case 'M': case 'm': return 3;  case 'G': case 'g': return 4;
    case 'R': case 'r': return 5;  case 'S': case 's': return 6;
    case 'V': case 'v': return 7;  case 'T': case 't': return 8;
    case 'W': case 'w': return 9;  case 'Y': case 'y': return 10;
    case 'H': case 'h': return 11; case 'K': case 'k': return 12;
    case 'D': case 'd': return 13; case 'B': case 'b': return 14;
    default:  return 15;  // N / anything else
  }
}

// Exact byte size of the encoded batch (for caller allocation).
int64_t ssq_bam_encode_size(int64_t n, const int64_t* qname_off,
                            const int64_t* cigar_off, const int64_t* seq_off,
                            const int64_t* aux_off) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lqname = qname_off[i + 1] - qname_off[i];
    int64_t ncig = cigar_off[i + 1] - cigar_off[i];
    int64_t lseq = seq_off[i + 1] - seq_off[i];
    int64_t laux = aux_off[i + 1] - aux_off[i];
    total += 4 + 32 + (lqname + 1) + 4 * ncig + (lseq + 1) / 2 + lseq + laux;
  }
  return total;
}

// Encode n records.  Inputs are struct-of-arrays; variable-length fields are
// concatenated blobs with n+1 exclusive-prefix offsets.  seq is ASCII bases
// ('*' unstored records pass an empty seq slice with qual slice also empty —
// then l_seq is written 0).  qual is raw phred (0xff run for missing).
// ref_end[i] must be pos+ref_len(cigar) (pos+1 if unmapped/no cigar) — the
// caller computes it; bin = reg2bin(pos, ref_end).  Returns bytes written.
int64_t ssq_bam_encode(int64_t n, const int32_t* tid, const int32_t* pos,
                       const int32_t* ref_end, const uint8_t* mapq,
                       const uint16_t* flag, const int32_t* mtid,
                       const int32_t* mpos, const int32_t* tlen,
                       const uint8_t* qname_blob, const int64_t* qname_off,
                       const uint32_t* cigar_blob, const int64_t* cigar_off,
                       const uint8_t* seq_blob, const uint8_t* qual_blob,
                       const int64_t* seq_off, const uint8_t* aux_blob,
                       const int64_t* aux_off, uint8_t* dst, int64_t dst_cap) {
  uint8_t* p = dst;
  uint8_t* pend = dst + dst_cap;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lqname = qname_off[i + 1] - qname_off[i];
    int64_t ncig = cigar_off[i + 1] - cigar_off[i];
    int64_t lseq = seq_off[i + 1] - seq_off[i];
    int64_t laux = aux_off[i + 1] - aux_off[i];
    int64_t body = 32 + (lqname + 1) + 4 * ncig + (lseq + 1) / 2 + lseq + laux;
    if (p + 4 + body > pend) return -1;
    uint32_t block_size = static_cast<uint32_t>(body);
    std::memcpy(p, &block_size, 4); p += 4;
    int32_t core[4] = {tid[i], pos[i],
                       0,  // packed below
                       0};
    uint32_t bin_mq_nl = (static_cast<uint32_t>(reg2bin(pos[i], ref_end[i])) << 16) |
                         (static_cast<uint32_t>(mapq[i]) << 8) |
                         static_cast<uint32_t>(lqname + 1);
    uint32_t flag_nc = (static_cast<uint32_t>(flag[i]) << 16) |
                       static_cast<uint32_t>(ncig);
    core[2] = static_cast<int32_t>(bin_mq_nl);
    core[3] = static_cast<int32_t>(flag_nc);
    std::memcpy(p, core, 16); p += 16;
    int32_t lseq32 = static_cast<int32_t>(lseq);
    std::memcpy(p, &lseq32, 4); p += 4;
    std::memcpy(p, &mtid[i], 4); p += 4;
    std::memcpy(p, &mpos[i], 4); p += 4;
    std::memcpy(p, &tlen[i], 4); p += 4;
    std::memcpy(p, qname_blob + qname_off[i], lqname); p += lqname;
    *p++ = 0;
    std::memcpy(p, cigar_blob + cigar_off[i], 4 * ncig); p += 4 * ncig;
    const uint8_t* sq = seq_blob + seq_off[i];
    for (int64_t j = 0; j + 1 < lseq; j += 2)
      *p++ = static_cast<uint8_t>((nt16_for_ascii(sq[j]) << 4) |
                                  nt16_for_ascii(sq[j + 1]));
    if (lseq & 1) *p++ = static_cast<uint8_t>(nt16_for_ascii(sq[lseq - 1]) << 4);
    std::memcpy(p, qual_blob + seq_off[i], lseq); p += lseq;
    std::memcpy(p, aux_blob + aux_off[i], laux); p += laux;
  }
  return p - dst;
}

// Scan a concatenated BAM record blob: count records and total sizes of the
// variable sections so the caller can allocate columnar outputs.
// out_counts = {n, qname_bytes, cigar_ops, seq_bytes, aux_bytes}.
int64_t ssq_bam_scan(const uint8_t* src, int64_t n, int64_t* out_counts) {
  int64_t off = 0, cnt = 0, qn = 0, cg = 0, sq = 0, ax = 0;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, src + off, 4);
    if (off + 4 + bs > static_cast<uint64_t>(n) || bs < 32) return -1;
    const uint8_t* r = src + off + 4;
    uint32_t bin_mq_nl, flag_nc;
    int32_t lseq;
    std::memcpy(&bin_mq_nl, r + 8, 4);
    std::memcpy(&flag_nc, r + 12, 4);
    std::memcpy(&lseq, r + 16, 4);
    int lqname = bin_mq_nl & 0xff;
    int ncig = flag_nc & 0xffff;
    int64_t fixed = 32 + lqname + 4 * ncig + (lseq + 1) / 2 + lseq;
    if (fixed > bs) return -1;
    qn += lqname - 1;
    cg += ncig;
    sq += lseq;
    ax += bs - fixed;
    ++cnt;
    off += 4 + bs;
  }
  if (off != n) return -1;
  out_counts[0] = cnt; out_counts[1] = qn; out_counts[2] = cg;
  out_counts[3] = sq; out_counts[4] = ax;
  return cnt;
}

// Decode a concatenated BAM record blob into columnar arrays (inverse of
// ssq_bam_encode; seq comes back as ASCII via "=ACMGRSVTWYHKDBN").
int64_t ssq_bam_decode(const uint8_t* src, int64_t n, int32_t* tid,
                       int32_t* pos, uint8_t* mapq, uint16_t* flag,
                       int32_t* mtid, int32_t* mpos, int32_t* tlen,
                       uint8_t* qname_blob, int64_t* qname_off,
                       uint32_t* cigar_blob, int64_t* cigar_off,
                       uint8_t* seq_blob, uint8_t* qual_blob, int64_t* seq_off,
                       uint8_t* aux_blob, int64_t* aux_off) {
  static const char kNt[] = "=ACMGRSVTWYHKDBN";
  int64_t off = 0, i = 0, qn = 0, cg = 0, sq = 0, ax = 0;
  qname_off[0] = cigar_off[0] = seq_off[0] = aux_off[0] = 0;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, src + off, 4);
    const uint8_t* r = src + off + 4;
    uint32_t bin_mq_nl, flag_nc;
    std::memcpy(&tid[i], r, 4);
    std::memcpy(&pos[i], r + 4, 4);
    std::memcpy(&bin_mq_nl, r + 8, 4);
    std::memcpy(&flag_nc, r + 12, 4);
    int32_t lseq;
    std::memcpy(&lseq, r + 16, 4);
    std::memcpy(&mtid[i], r + 20, 4);
    std::memcpy(&mpos[i], r + 24, 4);
    std::memcpy(&tlen[i], r + 28, 4);
    mapq[i] = (bin_mq_nl >> 8) & 0xff;
    flag[i] = static_cast<uint16_t>(flag_nc >> 16);
    int lqname = bin_mq_nl & 0xff;
    int ncig = flag_nc & 0xffff;
    const uint8_t* q = r + 32;
    std::memcpy(qname_blob + qn, q, lqname - 1);
    qn += lqname - 1;
    q += lqname;
    std::memcpy(cigar_blob + cg, q, 4 * ncig);
    cg += ncig;
    q += 4 * ncig;
    for (int j = 0; j < lseq; ++j)
      seq_blob[sq + j] = static_cast<uint8_t>(
          kNt[(q[j / 2] >> ((j & 1) ? 0 : 4)) & 0xf]);
    q += (lseq + 1) / 2;
    std::memcpy(qual_blob + sq, q, lseq);
    sq += lseq;
    q += lseq;
    int64_t laux = bs - (q - r);
    std::memcpy(aux_blob + ax, q, laux);
    ax += laux;
    ++i;
    qname_off[i] = qn; cigar_off[i] = cg; seq_off[i] = sq; aux_off[i] = ax;
    off += 4 + bs;
  }
  return i;
}

// ---------------------------------------------------------------------------
// Columnar record-assembly helpers for the align epilogue (the host side of
// the TPU pipeline).  The reference's analog is bwa's mem_aln2sam +
// samblaster's stream rewrite — per-record C hot loops; here they are batch
// calls over struct-of-arrays so Python never touches per-read strings.
// ---------------------------------------------------------------------------

// Render BAM-packed cigars (len<<4|op) to ASCII per record.
// out_off must have n+1 slots; returns total bytes or -1 on overflow.
int64_t ssq_cigar_strings(int64_t n, const uint32_t* cigar_blob,
                          const int64_t* cigar_off, uint8_t* dst,
                          int64_t dst_cap, int64_t* out_off) {
  static const char kOps[] = "MIDNSHP=XB";
  uint8_t* p = dst;
  uint8_t* pend = dst + dst_cap;
  out_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; ++c) {
      uint32_t v = cigar_blob[c];
      uint32_t len = v >> 4;
      char buf[12];
      int k = 0;
      do { buf[k++] = static_cast<char>('0' + len % 10); len /= 10; } while (len);
      if (p + k + 1 > pend) return -1;
      while (k) *p++ = static_cast<uint8_t>(buf[--k]);
      *p++ = static_cast<uint8_t>(kOps[v & 0xf]);
    }
    out_off[i + 1] = p - dst;
  }
  return p - dst;
}

namespace {
// Smallest-int aux encoding, matching formats/bam.py _encode_aux (htslib
// sam_parse1 semantics).
inline uint8_t* put_int_tag(uint8_t* p, char t0, char t1, int32_t v) {
  *p++ = static_cast<uint8_t>(t0);
  *p++ = static_cast<uint8_t>(t1);
  if (v < 0) {
    if (v >= -128) { *p++ = 'c'; *p++ = static_cast<uint8_t>(static_cast<int8_t>(v)); }
    else if (v >= -32768) {
      *p++ = 's'; int16_t x = static_cast<int16_t>(v);
      std::memcpy(p, &x, 2); p += 2;
    } else { *p++ = 'i'; std::memcpy(p, &v, 4); p += 4; }
  } else {
    if (v <= 255) { *p++ = 'C'; *p++ = static_cast<uint8_t>(v); }
    else if (v <= 65535) {
      *p++ = 'S'; uint16_t x = static_cast<uint16_t>(v);
      std::memcpy(p, &x, 2); p += 2;
    } else { *p++ = 'I'; uint32_t x = static_cast<uint32_t>(v);
      std::memcpy(p, &x, 4); p += 4; }
  }
  return p;
}
constexpr int32_t kAbsent = INT32_MIN;  // sentinel: tag not present
}  // namespace

// Build per-record aux blobs in the align pipeline's tag order:
//   NM:i  AS:i  XS:i  RG:Z  MC:Z  MQ:i  <extra raw bytes (SA/XA, rare)>
// nm/as_/xs/mq use INT32_MIN as the "absent" sentinel.  rg_idx selects a
// read-group string from rg_blob/rg_off.  mc_off zero-length span = no MC.
// extra_blob carries pre-encoded aux bytes appended verbatim.
// Returns total bytes written or -1 on overflow; out_off gets n+1 offsets.
int64_t ssq_build_aux(int64_t n, const int32_t* nm, const int32_t* as_,
                      const int32_t* xs, const int32_t* mq,
                      const int32_t* rg_idx, const uint8_t* rg_blob,
                      const int64_t* rg_off, const uint8_t* mc_blob,
                      const int64_t* mc_off, const uint8_t* extra_blob,
                      const int64_t* extra_off, uint8_t* dst, int64_t dst_cap,
                      int64_t* out_off) {
  uint8_t* p = dst;
  uint8_t* pend = dst + dst_cap;
  out_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t rgl = rg_off[rg_idx[i] + 1] - rg_off[rg_idx[i]];
    int64_t mcl = mc_off[i + 1] - mc_off[i];
    int64_t exl = extra_off[i + 1] - extra_off[i];
    // worst case: 3 int tags ×7 + RG hdr 4 + MC hdr 4 + MQ 7 + strings
    if (p + 3 * 7 + 4 + rgl + 1 + 4 + mcl + 1 + 7 + exl > pend) return -1;
    if (nm[i] != kAbsent) p = put_int_tag(p, 'N', 'M', nm[i]);
    if (as_[i] != kAbsent) p = put_int_tag(p, 'A', 'S', as_[i]);
    if (xs[i] != kAbsent) p = put_int_tag(p, 'X', 'S', xs[i]);
    if (rgl > 0) {
      *p++ = 'R'; *p++ = 'G'; *p++ = 'Z';
      std::memcpy(p, rg_blob + rg_off[rg_idx[i]], rgl); p += rgl;
      *p++ = 0;
    }
    if (mcl > 0) {
      *p++ = 'M'; *p++ = 'C'; *p++ = 'Z';
      std::memcpy(p, mc_blob + mc_off[i], mcl); p += mcl;
      *p++ = 0;
    }
    if (mq[i] != kAbsent) p = put_int_tag(p, 'M', 'Q', mq[i]);
    if (exl > 0) { std::memcpy(p, extra_blob + extra_off[i], exl); p += exl; }
    out_off[i + 1] = p - dst;
  }
  return p - dst;
}

// Find a 2-char Z-type aux tag in each record's aux blob span.
// Walks the tag list properly (no substring false positives).  Outputs
// per-record (offset into aux_blob, length) of the tag's string value,
// or (-1, 0) when absent.
int64_t ssq_find_ztag(const uint8_t* aux_blob, const int64_t* aux_off,
                      int64_t n, uint8_t t0, uint8_t t1,
                      int64_t* out_off, int64_t* out_len) {
  for (int64_t i = 0; i < n; ++i) {
    out_off[i] = -1;
    out_len[i] = 0;
    int64_t p = aux_off[i];
    int64_t end = aux_off[i + 1];
    while (p + 3 <= end) {
      uint8_t a = aux_blob[p], b = aux_blob[p + 1], t = aux_blob[p + 2];
      p += 3;
      int64_t vlen;
      switch (t) {
        case 'A': case 'c': case 'C': vlen = 1; break;
        case 's': case 'S': vlen = 2; break;
        case 'i': case 'I': case 'f': vlen = 4; break;
        case 'Z': case 'H': {
          int64_t q = p;
          while (q < end && aux_blob[q] != 0) ++q;
          vlen = q - p + 1;
          break;
        }
        case 'B': {
          if (p + 5 > end) { p = end; continue; }
          uint8_t et = aux_blob[p];
          uint32_t cnt;
          std::memcpy(&cnt, aux_blob + p + 1, 4);
          int es = (et == 'c' || et == 'C') ? 1
                   : (et == 's' || et == 'S') ? 2 : 4;
          vlen = 5 + static_cast<int64_t>(cnt) * es;
          break;
        }
        default: p = end; continue;  // malformed: stop this record
      }
      if (a == t0 && b == t1 && (t == 'Z' || t == 'H')) {
        out_off[i] = p;
        out_len[i] = vlen - 1;  // exclude NUL
        break;
      }
      p += vlen;
    }
  }
  return n;
}

// Parse cigar strings (e.g. from MC/SA tags) to reference-consumed length.
// spans give (offset, length) into blob per record; -1 offset → 0.
int64_t ssq_cigar_str_reflen(const uint8_t* blob, const int64_t* off,
                             const int64_t* len, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = 0;
    if (off[i] < 0) continue;
    int64_t p = off[i], end = off[i] + len[i];
    int64_t rl = 0, v = 0;
    while (p < end) {
      uint8_t c = blob[p++];
      if (c >= '0' && c <= '9') {
        v = v * 10 + (c - '0');
      } else {
        if (c == 'M' || c == 'D' || c == 'N' || c == '=' || c == 'X') rl += v;
        v = 0;
      }
    }
    out[i] = static_cast<int32_t>(rl);
  }
  return n;
}

// Reorder concatenated records: dst = blob[starts[order[k]] ..
// +sizes[order[k]]] for k in 0..n.  The external sorter's spill/write path
// (one call replaces n Python slice+write round trips).
int64_t ssq_gather_records(const uint8_t* blob, const int64_t* starts,
                           const int64_t* sizes, const int64_t* order,
                           int64_t n, uint8_t* dst, int64_t dst_cap) {
  uint8_t* p = dst;
  uint8_t* pend = dst + dst_cap;
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = order[k];
    int64_t sz = sizes[i];
    if (p + sz > pend) return -1;
    std::memcpy(p, blob + starts[i], sz);
    p += sz;
  }
  return p - dst;
}

// Pileup expansion: per-base projection of aligned (M/=/X) cigar ops
// into the window's span-compact flat layout + base/qual/strand counts,
// one C pass (the numpy expansion was the var/somatic host bottleneck:
// ~15 full passes + GIL-bound scatters over O(bases) arrays).
// Layout contracts mirror var/pileup.build_pileup_columns exactly.
int64_t ssq_pileup_expand(
    int64_t R,                     // kept reads
    const int64_t* pos,            // (R) absolute ref pos
    const int64_t* seq_off,        // (R) offset into seq/qual blobs
    const uint8_t* seq_blob,       // ASCII bases
    const uint8_t* qual_blob,      // raw quals (0xFF = missing -> q30)
    const uint32_t* cigar_blob,    // packed len<<4|op
    const int64_t* cig_lo,         // (R) first op index
    const int64_t* cig_hi,         // (R) one-past-last op index
    const int64_t* rstart,         // (R) window-relative span start
    const int64_t* base_idx,       // (R) flat span offset
    const int8_t* strand,          // (R) 0 fwd / 1 rev
    int64_t start, int64_t end, int64_t min_baseq,
    int8_t* flat_proj,             // (total) pre-filled -1
    int8_t* flat_qual,             // (total) pre-filled 0
    int32_t* flat_rpos,            // (total) pre-filled -1
    int32_t* base_counts,          // (L*5) zeroed
    int32_t* qual_sums,            // (L*5) zeroed
    int32_t* strand_counts         // (L*5*2) zeroed
) {
  // C++11 thread-safe local-static init (window threads call this
  // concurrently with the GIL released — a hand-rolled init flag would
  // be a data race)
  struct BaseCodeTable {
    int8_t t[256];
    BaseCodeTable() {
      for (int i = 0; i < 256; i++) t[i] = 4;
      t['A'] = t['a'] = 0;
      t['C'] = t['c'] = 1;
      t['G'] = t['g'] = 2;
      t['T'] = t['t'] = 3;
    }
  };
  static const BaseCodeTable kCode;
  const int8_t* code_of = kCode.t;
  for (int64_t r = 0; r < R; r++) {
    int64_t rp = pos[r];
    int64_t qp = 0;
    const int64_t so = seq_off[r];
    const int64_t b0 = base_idx[r] - start - rstart[r];
    const int8_t st = strand[r];
    for (int64_t ci = cig_lo[r]; ci < cig_hi[r]; ci++) {
      const uint32_t cg = cigar_blob[ci];
      const int64_t len = cg >> 4;
      const int op = cg & 0xF;
      const bool qcons = (op == 0 || op == 1 || op == 4 || op == 7 ||
                          op == 8);
      const bool rcons = (op == 0 || op == 2 || op == 3 || op == 7 ||
                          op == 8);
      if (qcons && rcons) {        // aligned M/=/X
        int64_t a = rp > start ? rp : start;
        int64_t b = rp + len < end ? rp + len : end;
        for (int64_t p = a; p < b; p++) {
          const int64_t qi = qp + (p - rp);
          const int8_t code = code_of[seq_blob[so + qi]];
          const uint8_t qraw = qual_blob[so + qi];
          const int8_t q = qraw == 0xFF ? 30 : (qraw > 60 ? 60 : (int8_t)qraw);
          const int64_t di = b0 + p;
          flat_rpos[di] = (int32_t)qi;
          flat_qual[di] = q;
          if (q >= min_baseq) {
            flat_proj[di] = code;
            const int64_t col = p - start;
            base_counts[col * 5 + code]++;
            qual_sums[col * 5 + code] += q;
            strand_counts[(col * 5 + code) * 2 + st]++;
          }
        }
      }
      if (qcons) qp += len;
      if (rcons) rp += len;
    }
  }
  return R;
}

// ---------------------------------------------------------------------------
// The realign extract's stream decode: lane BAMs read a chunk of whole BGZF
// blocks at a time, the whole records of each inflated chunk turned into the
// reads' padded rows in one pass (bamtofastq.py's role, without SAMRecords).
// ---------------------------------------------------------------------------

// Length of the longest prefix of src made of whole BGZF blocks; a block cut
// by the end of src is left for the next call.  -1 on a malformed header.
int64_t ssq_bgzf_whole(const uint8_t* src, int64_t n) {
  int64_t off = 0;
  while (n - off >= 18) {
    int64_t bs = block_bsize(src + off, n - off);
    if (bs < 0) {
      int xlen = src[off + 10] | (src[off + 11] << 8);
      if (n - off < kHeaderLen + xlen + 8) break;
      return -1;
    }
    if (bs > n - off) break;
    off += bs;
  }
  return off;
}

namespace {
// Bytes that the BAM record at r (past its block_size) needs for its fixed
// fields, name, cigar, sequence and qualities; -1 for a malformed length.
inline int64_t record_core_bytes(const uint8_t* r) {
  uint32_t bin_mq_nl, flag_nc;
  int32_t lseq;
  std::memcpy(&bin_mq_nl, r + 8, 4);
  std::memcpy(&flag_nc, r + 12, 4);
  std::memcpy(&lseq, r + 16, 4);
  int64_t lqname = bin_mq_nl & 0xff;
  if (lqname < 1 || lseq < 0) return -1;
  return 32 + lqname + 4 * static_cast<int64_t>(flag_nc & 0xffff) +
         (static_cast<int64_t>(lseq) + 1) / 2 + lseq;
}
}  // namespace

// Whole-record prefix of a BAM record stream: out = {its bytes, the rows
// ssq_bam_reads makes of it: records with no flag of skip_mask and l_seq >
// 0}.  A record cut by the end of src is left for the next call.  Returns
// the prefix's records, or -1 on a malformed record.
int64_t ssq_bam_whole(const uint8_t* src, int64_t n, uint16_t skip_mask,
                      int64_t* out) {
  int64_t off = 0, cnt = 0, rows = 0;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, src + off, 4);
    if (bs < 32) return -1;
    if (off + 4 + static_cast<int64_t>(bs) > n) break;
    const uint8_t* r = src + off + 4;
    int64_t core = record_core_bytes(r);
    if (core < 0 || core > bs) return -1;
    uint16_t flag;
    int32_t lseq;
    std::memcpy(&flag, r + 14, 2);
    std::memcpy(&lseq, r + 16, 4);
    if (!(flag & skip_mask) && lseq > 0) ++rows;
    ++cnt;
    off += 4 + bs;
  }
  out[0] = off;
  out[1] = rows;
  return cnt;
}

// The rows of the n bytes of whole records that ssq_bam_whole measured: each
// record with no flag of skip_mask and l_seq > 0 becomes row k of seq and
// qual (max_len bytes each): base codes A C G T = 0-3 and 4 for every other
// code, and phred qualities, in the read's original orientation (a record
// with a flag of turn_mask reverse-complemented, its qualities reversed), cut
// to max_len after the turn and padded with 4 and 0.  Qualities all 0xff
// (SAM's '*') read 30.  length[k]: the row's bases; flag[k]: the record's;
// qname_off/len and rg_off/len: the spans in src of its name and of its RG:Z
// value (rg_off -1 without one).  Writes at most cap rows and stops at a
// malformed record; returns the rows written.
int64_t ssq_bam_reads(const uint8_t* src, int64_t n, uint16_t skip_mask,
                      uint16_t turn_mask, int64_t max_len, int64_t cap,
                      uint8_t* seq, uint8_t* qual, int32_t* length,
                      uint16_t* flag, int64_t* qname_off, int64_t* qname_len,
                      int64_t* rg_off, int64_t* rg_len) {
  // nt16 code -> read code, as the forward strand and as its complement
  static const uint8_t kFwd[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                   3, 4, 4, 4, 4, 4, 4, 4};
  static const uint8_t kRev[16] = {4, 3, 2, 4, 1, 4, 4, 4,
                                   0, 4, 4, 4, 4, 4, 4, 4};
  int64_t off = 0, k = 0;
  while (off + 4 <= n && k < cap) {
    uint32_t bs;
    std::memcpy(&bs, src + off, 4);
    if (bs < 32 || off + 4 + static_cast<int64_t>(bs) > n) break;
    const uint8_t* r = src + off + 4;
    uint32_t bin_mq_nl, flag_nc;
    int32_t lseq;
    std::memcpy(&bin_mq_nl, r + 8, 4);
    std::memcpy(&flag_nc, r + 12, 4);
    std::memcpy(&lseq, r + 16, 4);
    int64_t core = record_core_bytes(r);
    if (core < 0 || core > bs) break;
    const int64_t lqname = bin_mq_nl & 0xff;
    const uint16_t f = static_cast<uint16_t>(flag_nc >> 16);
    if ((f & skip_mask) || lseq == 0) {
      off += 4 + bs;
      continue;
    }
    const uint8_t* nib = r + 32 + lqname + 4 * (flag_nc & 0xffff);
    const uint8_t* q = nib + (lseq + 1) / 2;
    const int64_t L = lseq < max_len ? lseq : max_len;
    uint8_t* srow = seq + k * max_len;
    uint8_t* qrow = qual + k * max_len;
    bool missing = true;
    for (int32_t j = 0; j < lseq && missing; ++j) missing = q[j] == 0xff;
    if (f & turn_mask) {
      for (int64_t j = 0; j < L; ++j) {
        const int64_t s = lseq - 1 - j;
        srow[j] = kRev[(nib[s >> 1] >> ((s & 1) ? 0 : 4)) & 0xf];
        qrow[j] = missing ? 30 : q[s];
      }
    } else {
      for (int64_t j = 0; j < L; ++j) {
        srow[j] = kFwd[(nib[j >> 1] >> ((j & 1) ? 0 : 4)) & 0xf];
        qrow[j] = missing ? 30 : q[j];
      }
    }
    std::memset(srow + L, 4, max_len - L);
    std::memset(qrow + L, 0, max_len - L);
    length[k] = static_cast<int32_t>(L);
    flag[k] = f;
    qname_off[k] = (r + 32) - src;
    qname_len[k] = lqname - 1;
    int64_t aux[2] = {(q + lseq) - src, off + 4 + static_cast<int64_t>(bs)};
    ssq_find_ztag(src, aux, 1, 'R', 'G', rg_off + k, rg_len + k);
    ++k;
    off += 4 + bs;
  }
  return k;
}

}  // extern "C"
