"""Device-resident reference and FMD index, in PyTorch.

Counterpart of speedseq_tpu/index/fm.py.  The hash seeding path reads only
the 2-bit packed forward reference (``ref_pack``, 16 bases per 32-bit
word, LSB-first) and its length: ``FMIndex.from_pac`` builds just those.
FM seeding (``seed_mode="fm"``) also reads the FMD arrays, which
``FMIndex.from_bwa_fm`` builds from the same ``BWAIndex`` and the full
suffix array:

- ``occ_ckpt`` (n_blocks+1, 4) int32 and ``bwt`` (n_blocks, 8) int32
  (uint32 bits, 16 bases per word, first base in the top bits) are
  row-gathered per occ lookup; counting is a 2-bit pattern match plus a
  popcount (SWAR in int64 here: torch has no popcount);
- the SA is position-sampled (every 32nd text position marked in a rank
  bitmap with popcount checkpoints), so an LF walk (``ops/fm_search.py``:
  ``fm_sa_walk``) meets a sample within 32 steps; indexes of at most
  ``dense_sa_max`` ranks also keep the full SA (``sa_dense``), and a
  lookup is one gather;
- indexes on the card without the full SA also carry ``walk_rec``
  (``walk_records``; the CPU walk, ``fm_sa_walk_plain``, reads none):
  one 64-byte record per 128-row block of stored BWT rows holding what an
  LF step of the walk reads (a checkpoint at the block's middle row, the
  block's 8 BWT words, its rows' SA mark bits), so that a step touches one
  line of device memory.  It costs 0.5 B a rank (128 MB at 2^28 ranks,
  1 GiB at the 2^31 - 1 limit).

Rank-space convention (bwa's): the conceptual BWT has seq_len+1 rows
including the sentinel row at ``primary``; the stored arrays skip it and
occ adjusts with ``k -= (k > primary)``.  uint32 word arithmetic runs in
int64 masked with ``& 0xFFFFFFFF``.  Ranks, SA values and the kernels'
rank arithmetic are int32, so an index holds at most 2^31 - 1 ranks
(genomes to ~1 Gbp per index shard); ``from_bwa_fm`` refuses larger ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .bwt import OCC_INTERVAL, BWAIndex

BASES_PER_WORD = 16
WORDS_PER_BLOCK = OCC_INTERVAL // BASES_PER_WORD  # 8
SA_POS_INTV = 32  # SA sampled at text positions ≡ 0 (mod 32)
# ``from_bwa_fm``'s default: indexes of at most this many ranks keep the
# full SA (32 Mi: ~16 Mbp of genome); larger ones take the LF walk
DENSE_SA_MAX = 1 << 25
# ranks are int32 (0 .. seq_len + 1 as an interval end)
MAX_RANKS = 2**31 - 1
_M32 = 0xFFFFFFFF
# each base code replicated in every 2-bit slot
_PATTERNS = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)


class FMIndex(NamedTuple):
    ref_pack: torch.Tensor   # (ceil(l_pac/16),) int32 words (uint32 bits)
    l_pac: int
    # FMD arrays: None on the hash path
    count: Optional[torch.Tensor] = None     # (4,) int32, C'[c] = 1 + L2[c]
    occ_ckpt: Optional[torch.Tensor] = None  # (n_blocks+1, 4) int32
    bwt: Optional[torch.Tensor] = None       # (n_blocks, 8) int32 words
    sa_mark: Optional[torch.Tensor] = None   # (ceil((seq_len+1)/32),) int32
    # bitmap, LSB-first
    sa_ckpt: Optional[torch.Tensor] = None   # same shape: marks in [0, 32w)
    sa_vals: Optional[torch.Tensor] = None   # (n_marked,) int32 SA values
    sa_dense: Optional[torch.Tensor] = None  # (seq_len+1,) int32 full SA
    primary: int = 0
    seq_len: int = 0                         # 2 * l_pac
    # (n_blocks + 1, 16) int32 LF-walk records (``walk_records``), where a
    # cuda index keeps no full SA; else None
    walk_rec: Optional[torch.Tensor] = None

    @classmethod
    def from_pac(cls, pac: np.ndarray, device="cpu") -> "FMIndex":
        l_pac = len(pac)
        nw = (l_pac + 15) // 16
        codes16 = np.zeros(nw * 16, dtype=np.uint32)
        codes16[:l_pac] = np.asarray(pac) & 3
        ref_pack = np.zeros(nw, dtype=np.uint32)
        for t in range(16):
            ref_pack |= codes16[t::16] << np.uint32(2 * t)
        if not nw:
            ref_pack = np.zeros(1, np.uint32)
        return cls(
            ref_pack=torch.from_numpy(ref_pack.view(np.int32)).to(device),
            l_pac=int(l_pac),
        )

    @classmethod
    def from_bwa(cls, idx: BWAIndex, device="cpu") -> "FMIndex":
        return cls.from_pac(idx.pac, device)

    @classmethod
    def from_bwa_fm(cls, idx: BWAIndex, sa_full: Optional[np.ndarray] = None,
                    device="cpu", dense_sa_max: int = DENSE_SA_MAX
                    ) -> "FMIndex":
        """The packed reference plus the FMD arrays.  ``sa_full`` (the
        full suffix array, length seq_len+1) is reconstructed from the
        index when not given; the full SA is kept when the index has at
        most ``dense_sa_max`` ranks.  Raises ValueError above MAX_RANKS
        ranks, where int32 rank arithmetic would wrap."""
        n = int(idx.L2[4])
        if n + 1 > MAX_RANKS:
            raise ValueError(
                f"the FM index has {n + 1} ranks; int32 rank arithmetic "
                f"holds at most {MAX_RANKS} (a genome of ~1 Gbp per index)")
        n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
        words = np.zeros(n_blocks * WORDS_PER_BLOCK, dtype=np.uint32)
        words[: len(idx.bwt_words)] = idx.bwt_words
        if sa_full is None:
            sa_full = _reconstruct_sa(idx)
        n_ranks = n + 1
        mark = np.zeros(((n_ranks + 31) // 32) * 32, dtype=bool)
        mark[:n_ranks] = (sa_full % SA_POS_INTV) == 0
        # bit b of word w is rank 32w + b (LSB-first bytes, little-endian)
        sa_mark = np.packbits(mark, bitorder="little").view("<u4")
        counts = mark.reshape(-1, 32).sum(axis=1)
        sa_ckpt = np.concatenate(([0], np.cumsum(counts[:-1]))).astype(np.int32)
        sa_vals = sa_full[mark[:n_ranks]].astype(np.int32)
        t = lambda a: torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32)).to(device)
        base = cls.from_pac(idx.pac, device)
        fm = base._replace(
            count=t((1 + idx.L2[:4]).astype(np.int32)),
            occ_ckpt=t(idx.occ.astype(np.int32)),
            bwt=t(words.reshape(n_blocks, WORDS_PER_BLOCK)),
            sa_mark=t(sa_mark.astype(np.uint32)),
            sa_ckpt=t(sa_ckpt),
            sa_vals=t(sa_vals),
            sa_dense=(t(sa_full.astype(np.int32)) if n_ranks <= dense_sa_max
                      else None),
            primary=int(idx.primary),
            seq_len=n,
        )
        if fm.sa_dense is None and torch.device(device).type == "cuda":
            fm = fm._replace(walk_rec=walk_records(fm))
        return fm


def _reconstruct_sa(idx: BWAIndex) -> np.ndarray:
    """Full suffix array (int64, length seq_len+1) from the BWT and the
    index's rank samples (every ``sa_intv``-th rank's SA value, rank 0
    being the sentinel suffix at seq_len).

    LF(r) is the rank of the suffix one position to the left of rank r's,
    so SA[LF(r)] = SA[r] - 1.  A walker starts at every sampled rank and
    steps LF, writing each value, until it reaches the next sampled rank
    (or position 0, the row at ``primary``).  All walkers step together,
    so the loop runs as often as the longest gap between sampled
    positions (~sa_intv · ln(n / sa_intv)), not n times as one walk
    would."""
    n = int(idx.L2[4])
    primary = int(idx.primary)
    intv = int(idx.sa_intv)
    codes = np.zeros(len(idx.bwt_words) * 16, dtype=np.uint8)
    for j in range(16):
        codes[j::16] = (idx.bwt_words >> np.uint32((15 - j) * 2)) & 3
    codes = codes[:n]
    # LF of every stored row: C'[c] + the row's order among rows of code c
    lf = np.empty(n, dtype=np.int64)
    count = (1 + idx.L2[:4]).astype(np.int64)
    for c in range(4):
        rows = np.flatnonzero(codes == c)
        lf[rows] = count[c] + np.arange(len(rows), dtype=np.int64)
    sa = np.empty(n + 1, dtype=np.int64)
    r = np.arange(0, n + 1, intv, dtype=np.int64)
    p = np.asarray(idx.sa_samples[: len(r)], dtype=np.int64).copy()
    p[0] = n
    sa[r] = p
    while len(r):
        live = p > 0                 # SA 0 sits at primary: no LF from it
        r, p = r[live], p[live] - 1
        r = lf[r - (r > primary)]
        fresh = r % intv != 0        # a sampled rank is another walk's start
        r, p = r[fresh], p[fresh]
        sa[r] = p
    return sa


# ----------------------------------------------------- the walk's records

WALK_REC_INTS = 16      # a record: mid checkpoint 4, BWT words 8, marks 4
_REC_CHUNK = 1 << 20    # blocks built at a time (bounds the int64 temporaries)


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values holding uint32 words -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def walk_records(fm: FMIndex) -> torch.Tensor:
    """The LF walk's records, (n_blocks + 1, 16) int32 on the index's
    device: per 128-row block b of stored BWT rows,

    - ints 0-3: occurrences of each base in stored rows [0, m), m =
      min(128 b + 64, seq_len) (a checkpoint at the block's middle row:
      a row of the lower half counts down to it, a row of the upper half
      up from it, so a step reads one checkpoint and one half-block);
    - ints 4-11: the block's 8 BWT words (``bwt``);
    - ints 12-15: the SA mark bits of the block's stored rows, bit j of
      int 12 + q for stored row 128 b + 32 q + j.  Stored row kk is rank
      kk + (kk >= primary); the sentinel rank ``primary`` has no stored
      row (SA 0, always marked: the walk tests it apart).

    The last record is zero: the walk loads row kk = primary of the
    sentinel rank before it tests the rank, and where primary == seq_len
    is a multiple of 128 that row is past the last block."""
    i64 = torch.int64
    dev = fm.bwt.device
    nb = fm.bwt.shape[0]
    marks = fm.sa_mark.to(i64) & _M32
    rank_words = torch.zeros(4 * nb + 1, dtype=i64, device=dev)
    rank_words[: marks.shape[0]] = marks[: 4 * nb + 1]
    parts = []
    for b0 in range(0, nb, _REC_CHUNK):
        blk = torch.arange(b0, min(nb, b0 + _REC_CHUNK), dtype=i64,
                           device=dev)
        lower = (fm.seq_len - blk * OCC_INTERVAL).clamp(0, OCC_INTERVAL // 2)
        wi = torch.arange(WORDS_PER_BLOCK // 2, dtype=i64, device=dev)
        valid = (lower[:, None] - wi * BASES_PER_WORD).clamp(
            0, BASES_PER_WORD)
        mid = fm.occ_ckpt[blk] + _word_count_all(
            fm.bwt[blk, : WORDS_PER_BLOCK // 2], valid)
        # stored-row word q: rank bits 32q + j below primary, 32q + j + 1
        # from it on (the rank words shifted down one bit)
        q = (blk[:, None] * 4 + wi).reshape(-1)
        here, nxt = rank_words[q], rank_words[q + 1]
        shifted = (here >> 1) | ((nxt & 1) << 31)
        below = (torch.ones_like(q) << (fm.primary - 32 * q).clamp(0, 32)) - 1
        stored = (here & below) | (shifted & ~below & _M32)
        parts.append(torch.cat([mid.to(torch.int32), fm.bwt[blk],
                                _as_int32_bits(stored).reshape(-1, 4)], 1))
    parts.append(torch.zeros(1, WALK_REC_INTS, dtype=torch.int32,
                             device=dev))
    return torch.cat(parts).contiguous()


# ------------------------------------------------------------ occ and LF

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values holding 32-bit words (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _word_count_all(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Count each base (0-3) among the first ``valid`` of 16 bases/word.

    words: (..., 8) int32 (uint32 bits); valid: (..., 8) in [0, 16];
    returns (..., 4) int32.  The mask is the top 2·valid bits, written
    so that no shift reaches 32 (0 bases: no bits, 16: all)."""
    w = words.to(torch.int64) & _M32
    nbits = 2 * valid.to(torch.int64)
    ones = (torch.ones_like(nbits) << nbits) - 1
    mask = torch.where(valid >= 16, _M32, ones << (32 - nbits)) & _M32
    patt = torch.tensor(_PATTERNS, dtype=torch.int64, device=words.device)
    nx = ~(w[..., None] ^ patt) & _M32             # (..., 8, 4)
    slot_match = nx & (nx >> 1) & 0x55555555
    cnt = _popcount32(slot_match & mask[..., None])
    return cnt.sum(dim=-2).to(torch.int32)


def occ_all(fm: FMIndex, k: torch.Tensor) -> torch.Tensor:
    """Occurrences of each base in conceptual BWT rows [0, k).

    k: (...,) ranks in [0, seq_len+1]; returns (..., 4) int32 (bwa
    bwt_occ4, with the primary-row adjustment)."""
    k = k.to(torch.int64)
    kk = (k - (k > fm.primary).to(torch.int64)).clamp(0, fm.seq_len)
    block = kk // OCC_INTERVAL
    within = kk - block * OCC_INTERVAL
    ckpt = fm.occ_ckpt[block]
    words = fm.bwt[block.clamp(0, fm.bwt.shape[0] - 1)]
    wi = torch.arange(WORDS_PER_BLOCK, dtype=torch.int64, device=k.device)
    valid = (within[..., None] - wi * BASES_PER_WORD).clamp(0, BASES_PER_WORD)
    return ckpt + _word_count_all(words, valid)


def bwt_char(fm: FMIndex, k: torch.Tensor) -> torch.Tensor:
    """Base code of conceptual BWT row k (undefined at k == primary;
    callers handle that row)."""
    k = k.to(torch.int64)
    kk = (k - (k > fm.primary).to(torch.int64)).clamp(0, fm.seq_len - 1)
    word = fm.bwt[kk // OCC_INTERVAL,
                  (kk % OCC_INTERVAL) // BASES_PER_WORD].to(torch.int64) & _M32
    sh = (15 - kk % BASES_PER_WORD) * 2
    return ((word >> sh) & 3).to(torch.int32)


class BiInterval(NamedTuple):
    """FMD bi-interval (k, l, s): k on the BWT, l on the mirror strand."""

    k: torch.Tensor
    l: torch.Tensor
    s: torch.Tensor


def interval_init(fm: FMIndex, c: torch.Tensor) -> BiInterval:
    """Bi-interval of the single-base string c (bwa bwt_set_intv); c >= 4
    gives an empty interval."""
    c_ = c.clamp(0, 3).to(torch.int64)
    hi_counts = torch.cat([fm.count, fm.count.new_tensor([fm.seq_len + 1])])
    lo = fm.count[c_]
    s = torch.where(c < 4, hi_counts[c_ + 1] - lo, 0).to(torch.int32)
    lc = fm.count[(3 - c).clamp(0, 3).to(torch.int64)]
    return BiInterval(k=lo, l=torch.where(c < 4, lc, lo), s=s)


def backward_ext_all(fm: FMIndex, iv: BiInterval) -> BiInterval:
    """All-4-bases backward extension (bwa bwt_extend, is_back=1); fields
    shaped (..., 4)."""
    occ_lo = occ_all(fm, iv.k)
    occ_hi = occ_all(fm, iv.k + iv.s)
    cnt = occ_hi - occ_lo
    has_sentinel = ((fm.primary >= iv.k)
                    & (fm.primary < iv.k + iv.s)).to(torch.int32)
    ck = fm.count + occ_lo
    # l'[c] = l + sentinel_in_interval + Σ_{b>c} cnt[b]  (Li 2012)
    rev = cnt.flip(-1)
    upper = (torch.cumsum(rev, dim=-1) - rev).flip(-1).to(torch.int32)
    cl = (iv.l + has_sentinel)[..., None] + upper
    return BiInterval(k=ck, l=cl, s=cnt)


def backward_ext(fm: FMIndex, iv: BiInterval, c: torch.Tensor) -> BiInterval:
    """Prepend base c; c >= 4 gives an empty interval.  Keeps the old k
    and l when the extension empties, but sets s (callers test s)."""
    a = backward_ext_all(fm, iv)
    ci = c.clamp(0, 3).to(torch.int64)[..., None]
    take = lambda t: t.gather(-1, ci)[..., 0]
    ok = (c < 4) & (take(a.s) > 0)
    return BiInterval(
        k=torch.where(ok, take(a.k), iv.k),
        l=torch.where(ok, take(a.l), iv.l),
        s=torch.where(c < 4, take(a.s), 0).to(torch.int32),
    )


def forward_ext(fm: FMIndex, iv: BiInterval, c: torch.Tensor) -> BiInterval:
    """Append base c: backward-extend the mirror interval with the
    complement of c, then swap (FMD symmetry)."""
    ext = backward_ext(fm, BiInterval(k=iv.l, l=iv.k, s=iv.s),
                       torch.where(c < 4, 3 - c, c))
    return BiInterval(k=ext.l, l=ext.k, s=ext.s)


def get_ref_window(fm: FMIndex, start: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Forward reference [start, start+length) as (..., length) uint8
    codes from any starts (one gather a base from the packed words);
    out-of-range positions yield 4 (never matches)."""
    dev = start.device
    pos = start.to(torch.int64)[..., None] + torch.arange(length, device=dev)
    words = fm.ref_pack[(pos >> 4).clamp(0, fm.ref_pack.shape[0] - 1)]
    codes = (words >> ((pos & 15) * 2).to(torch.int32)) & 3
    inb = (pos >= 0) & (pos < fm.l_pac)
    return torch.where(inb, codes, 4).to(torch.uint8)


def get_ref_window_packed(fm: FMIndex, start16: torch.Tensor,
                          length: int) -> torch.Tensor:
    """Forward reference [start16, start16+length) as (..., length) uint8
    codes from 16-aligned starts (word gathers); out-of-range positions
    yield 4."""
    dev = start16.device
    start16 = start16.to(torch.int64)
    nw = (length + 15) // 16
    widx = (torch.div(start16, 16, rounding_mode="floor")[..., None]
            + torch.arange(nw, device=dev))
    words = fm.ref_pack[widx.clamp(0, fm.ref_pack.shape[0] - 1)]
    sh = torch.arange(16, dtype=torch.int32, device=dev) * 2
    codes = (words[..., None] >> sh) & 3            # (..., nw, 16)
    codes = codes.reshape(*start16.shape, nw * 16)[..., :length]
    pos = start16[..., None] + torch.arange(length, device=dev)
    inb = (pos >= 0) & (pos < fm.l_pac)
    return torch.where(inb, codes, 4).to(torch.uint8)
