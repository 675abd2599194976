"""CRAM 3.0 reader (decode-only).

The reference accepts CRAM inputs for ``sv`` (magic checks
bin/speedseq:97-134; LUMPY branch ``0.2.13_cram_support``,
.gitmodules:28) and htslib carries the full codec
(src/samtools-1.3.1/htslib-1.3.1/cram/).  This module implements the
public CRAM 3.0 specification [external knowledge: samtools hts-specs
CRAMv3] sufficiently to decode real-world CRAMs into
:class:`~speedseq_tpu_torch.formats.sam.SAMRecord` objects:

- ITF8/LTF8 varints, container/block structure, CRC-carrying v3 blocks
- block compression: raw, gzip, bzip2, lzma, rANS 4x8 (order 0 and 1)
- codecs: EXTERNAL, HUFFMAN (canonical), BETA, GAMMA, BYTE_ARRAY_LEN,
  BYTE_ARRAY_STOP
- record reconstruction: bit flags, positions (AP delta), read names,
  detached/downstream mate linkage with TLEN recomputation, tag
  dictionaries, read features (substitutions via the SM matrix,
  ins/del/clips/skips/pads), sequence rebuild against the reference
  (external FASTA or embedded reference block), quality scores

Writing CRAM is deliberately out of scope (the reference itself only
READS CRAM — every writer in the pipeline emits BAM).  Conformance is
tested against htslib's ``*_java.cram`` vectors with their paired SAM
truth (tests/test_formats.py).
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .sam import SAMHeader, SAMRecord, cigar_ref_len

CRAM_MAGIC = b"CRAM"

# block content types
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# BAM flag bits used during reconstruction
_FPAIRED, _FPROPER = 0x1, 0x2
_FUNMAP, _FMUNMAP = 0x4, 0x8
_FREVERSE, _FMREVERSE = 0x10, 0x20
_FREAD1, _FREAD2 = 0x40, 0x80

# CRAM record (CF) flags
CF_QS_PRESERVED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

class ByteReader:
    __slots__ = ("b", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.b = data
        self.pos = pos

    def u8(self) -> int:
        v = self.b[self.pos]
        self.pos += 1
        return v

    def read(self, n: int) -> bytes:
        v = self.b[self.pos : self.pos + n]
        self.pos += n
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.b, self.pos)
        self.pos += 4
        return v

    def itf8(self) -> int:
        """ITF8 per htslib itf8_get (cram/cram_io.c)."""
        c = self.u8()
        if not c & 0x80:
            v = c
        elif not c & 0x40:
            v = ((c & 0x3F) << 8) | self.u8()
        elif not c & 0x20:
            v = ((c & 0x1F) << 16) | (self.u8() << 8)
            v |= self.u8()
        elif not c & 0x10:
            v = ((c & 0x0F) << 24) | (self.u8() << 16)
            v |= self.u8() << 8
            v |= self.u8()
        else:
            v = ((c & 0x0F) << 28) | (self.u8() << 20)
            v |= self.u8() << 12
            v |= self.u8() << 4
            v |= self.u8() & 0x0F
        if v & 0x80000000:
            v -= 1 << 32
        return v

    def ltf8(self) -> int:
        """LTF8 per htslib ltf8_get."""
        c = self.u8()
        if not c & 0x80:
            v = c
        elif not c & 0x40:
            v = ((c & 0x3F) << 8) | self.u8()
        elif not c & 0x20:
            v = ((c & 0x1F) << 16) | (self.u8() << 8)
            v |= self.u8()
        elif not c & 0x10:
            v = ((c & 0x0F) << 24) | (self.u8() << 16)
            v |= self.u8() << 8
            v |= self.u8()
        elif not c & 0x08:
            v = ((c & 0x07) << 32) | (self.u8() << 24)
            v |= self.u8() << 16
            v |= self.u8() << 8
            v |= self.u8()
        elif not c & 0x04:
            v = ((c & 0x03) << 40) | (self.u8() << 32)
            v |= self.u8() << 24
            v |= self.u8() << 16
            v |= self.u8() << 8
            v |= self.u8()
        elif not c & 0x02:
            v = ((c & 0x01) << 48) | (self.u8() << 40)
            v |= self.u8() << 32
            v |= self.u8() << 24
            v |= self.u8() << 16
            v |= self.u8() << 8
            v |= self.u8()
        elif not c & 0x01:
            v = self.u8() << 48
            v |= self.u8() << 40
            v |= self.u8() << 32
            v |= self.u8() << 24
            v |= self.u8() << 16
            v |= self.u8() << 8
            v |= self.u8()
        else:
            v = 0
            for _ in range(8):
                v = (v << 8) | self.u8()
        if v & (1 << 63):
            v -= 1 << 64
        return v


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("b", "pos", "bit")

    def __init__(self, data: bytes):
        self.b = data
        self.pos = 0
        self.bit = 7

    def read_bit(self) -> int:
        v = (self.b[self.pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return v

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


# ---------------------------------------------------------------------------
# rANS 4x8 decoder (order 0 / order 1) [external knowledge: hts-specs]
# ---------------------------------------------------------------------------

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
_RANS_LOW = 1 << 23


def _rans_freq(r: ByteReader) -> int:
    """7/15-bit frequency: 1 byte, or 2 bytes when ≥128
    (rANS_static.c:596-599); stored 0 means TOTFREQ."""
    f = r.u8()
    if f >= 128:
        f = ((f & 127) << 8) | r.u8()
    return f if f else _TOTFREQ


def _rans_freqs0(r: ByteReader):
    """Order-0 frequency table — exact rANS_static.c semantics: symbol
    runs RLE'd by peeking whether the NEXT byte equals sym+1 (no 8-bit
    wrap: symbol 255 never RLE-triggers)."""
    freq = np.zeros(256, np.int64)
    rle = 0
    j = r.u8()
    while True:
        freq[j] = _rans_freq(r)
        if rle == 0 and r.pos < len(r.b) and r.b[r.pos] == j + 1:
            j = r.u8()
            rle = r.u8()
        elif rle > 0:
            rle -= 1
            j += 1
        else:
            j = r.u8()
        if j == 0:
            break
    cum = np.zeros(257, np.int64)
    cum[1:] = np.cumsum(freq)
    lookup = np.zeros(_TOTFREQ, np.uint8)
    for sy in range(256):
        if freq[sy]:
            lookup[cum[sy] : cum[sy] + freq[sy]] = sy
    return freq, cum, lookup


def _rans_decode_0(r: ByteReader, out_size: int) -> bytes:
    freq, cum, lookup = _rans_freqs0(r)
    states = [struct.unpack("<I", r.read(4))[0] for _ in range(4)]
    out = bytearray(out_size)
    b = r.b
    pos = r.pos
    mask = _TOTFREQ - 1
    for i in range(out_size):
        j = i & 3
        x = states[j]
        f = x & mask
        s = lookup[f]
        out[i] = s
        x = int(freq[s]) * (x >> _TF_SHIFT) + f - int(cum[s])
        while x < _RANS_LOW and pos < len(b):
            x = (x << 8) | b[pos]
            pos += 1
        states[j] = x
    r.pos = pos
    return bytes(out)


def _rans_decode_1(r: ByteReader, out_size: int) -> bytes:
    # order-1: context tables freq[ctx][sym]
    freq = np.zeros((256, 256), np.int64)
    cum = np.zeros((256, 257), np.int64)
    lookup = np.zeros((256, _TOTFREQ), np.uint8)
    rle_i = 0
    i = r.u8()
    while True:
        # inner order-0 table for context i (same RLE scheme outer)
        f, c, lk = _rans_freqs0(r)
        freq[i], cum[i], lookup[i, : len(lk)] = f, c, lk
        if rle_i == 0 and r.pos < len(r.b) and r.b[r.pos] == i + 1:
            i = r.u8()
            rle_i = r.u8()
        elif rle_i > 0:
            rle_i -= 1
            i += 1
        else:
            i = r.u8()
        if i == 0:
            break
    states = [struct.unpack("<I", r.read(4))[0] for _ in range(4)]
    ctx = [0, 0, 0, 0]
    out = bytearray(out_size)
    b = r.b
    pos = r.pos
    mask = _TOTFREQ - 1
    # 4 interleaved streams over quarters of the output
    q = out_size >> 2
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, out_size]
    idx = list(starts)
    done = 0
    while done < 4:
        done = 0
        for j in range(4):
            if idx[j] >= ends[j]:
                done += 1
                continue
            x = states[j]
            cj = ctx[j]
            f = x & mask
            s = int(lookup[cj, f])
            out[idx[j]] = s
            x = int(freq[cj, s]) * (x >> _TF_SHIFT) + f - int(cum[cj, s])
            while x < _RANS_LOW and pos < len(b):
                x = (x << 8) | b[pos]
                pos += 1
            states[j] = x
            ctx[j] = s
            idx[j] += 1
    r.pos = pos
    return bytes(out)


def rans_uncompress(data: bytes) -> bytes:
    r = ByteReader(data)
    order = r.u8()
    _csize = struct.unpack("<I", r.read(4))[0]
    usize = struct.unpack("<I", r.read(4))[0]
    if order == 0:
        return _rans_decode_0(r, usize)
    if order == 1:
        return _rans_decode_1(r, usize)
    raise ValueError(f"unsupported rANS order {order}")


# ---------------------------------------------------------------------------
# blocks + containers
# ---------------------------------------------------------------------------

@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes


def _read_block(fh, version: int) -> Block:
    head = fh.read(2)
    if len(head) < 2:
        raise EOFError
    method, ctype = head
    r = ByteReader(fh.read(15))  # 3 varints, ≤5 bytes each
    content_id = r.itf8()
    comp_size = r.itf8()
    raw_size = r.itf8()
    # we over-read: rewind the file to just past the varints
    fh.seek(r.pos - len(r.b), io.SEEK_CUR)
    data = fh.read(comp_size)
    if version >= 3:
        fh.read(4)  # CRC32
    if raw_size == 0 or not data:
        raw = b""
    elif method == 0:
        raw = data
    elif method == 1:
        raw = zlib.decompress(data, 31)
    elif method == 2:
        import bz2

        raw = bz2.decompress(data)
    elif method == 3:
        import lzma

        raw = lzma.decompress(data)
    elif method == 4:
        raw = rans_uncompress(data)
    else:
        raise ValueError(f"unsupported CRAM block method {method}")
    if len(raw) != raw_size:
        raise ValueError(
            f"block decode size mismatch: {len(raw)} != {raw_size}")
    return Block(method, ctype, content_id, raw)


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: List[int]


def _read_container_header(fh, version: int) -> ContainerHeader:
    raw = fh.read(4)
    if len(raw) < 4:
        raise EOFError
    (length,) = struct.unpack("<i", raw)
    # fixed varint fields are ≤ 48 bytes; the landmark list is NOT
    # bounded (n_landmarks × ≤5 bytes for multi-slice containers), so
    # the buffer is extended once n_landmarks is known instead of
    # capping at 64 bytes (a multi-slice container overran the cap and
    # broke the forward seek — ADVICE r4)
    buf = fh.read(64)
    r = ByteReader(buf)
    ref_id = r.itf8()
    start = r.itf8()
    span = r.itf8()
    n_rec = r.itf8()
    counter = r.ltf8() if version >= 2 else 0
    bases = r.ltf8()
    n_blocks = r.itf8()
    n_land = r.itf8()
    need = n_land * 5 + 4          # worst-case landmarks + CRC
    if len(buf) - r.pos < need:
        extra = fh.read(need - (len(buf) - r.pos))
        buf += extra
        r.b = buf
    lands = [r.itf8() for _ in range(n_land)]
    if version >= 3:
        r.read(4)  # CRC
    fh.seek(r.pos - len(buf), io.SEEK_CUR)
    return ContainerHeader(length, ref_id, start, span, n_rec, counter,
                           bases, n_blocks, lands)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class Codec:
    def decode_int(self, core: BitReader, ext: Dict[int, ByteReader]) -> int:
        raise NotImplementedError

    def decode_bytes(self, core, ext, n: Optional[int] = None) -> bytes:
        raise NotImplementedError


class ExternalCodec(Codec):
    def __init__(self, cid: int):
        self.cid = cid

    def decode_int(self, core, ext):
        return ext[self.cid].itf8()

    def decode_byte(self, core, ext):
        return ext[self.cid].u8()

    def decode_bytes(self, core, ext, n=None):
        return ext[self.cid].read(n)


class HuffmanCodec(Codec):
    """Canonical Huffman over an int alphabet; 0-bit single-symbol case
    is the overwhelmingly common encoding for constants."""

    def __init__(self, alphabet: List[int], lengths: List[int]):
        self.single = alphabet[0] if len(alphabet) == 1 else None
        # build canonical codes sorted by (len, symbol order as given)
        pairs = sorted(zip(lengths, range(len(alphabet))))
        self.codes = []  # (length, code, symbol)
        code = 0
        prev_len = 0
        for ln, idx in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self.codes.append((ln, code, alphabet[idx]))
            code += 1
        self.by_len: Dict[int, Dict[int, int]] = {}
        for ln, c, sym in self.codes:
            self.by_len.setdefault(ln, {})[c] = sym

    def decode_int(self, core, ext):
        if self.single is not None:
            return self.single
        v = 0
        ln = 0
        while True:
            v = (v << 1) | core.read_bit()
            ln += 1
            d = self.by_len.get(ln)
            if d is not None and v in d:
                return d[v]
            if ln > 31:
                raise ValueError("bad huffman stream")

    decode_byte = decode_int


class BetaCodec(Codec):
    def __init__(self, offset: int, nbits: int):
        self.offset = offset
        self.nbits = nbits

    def decode_int(self, core, ext):
        return core.read_bits(self.nbits) - self.offset

    decode_byte = decode_int


class GammaCodec(Codec):
    def __init__(self, offset: int):
        self.offset = offset

    def decode_int(self, core, ext):
        n = 0
        while core.read_bit() == 0:
            n += 1
        v = 1
        for _ in range(n):
            v = (v << 1) | core.read_bit()
        return v - 1 - self.offset

    decode_byte = decode_int


class ByteArrayLenCodec(Codec):
    def __init__(self, len_codec: Codec, val_codec: Codec):
        self.len_codec = len_codec
        self.val_codec = val_codec

    def decode_bytes(self, core, ext, n=None):
        ln = self.len_codec.decode_int(core, ext)
        if isinstance(self.val_codec, ExternalCodec):
            return self.val_codec.decode_bytes(core, ext, ln)
        return bytes(self.val_codec.decode_byte(core, ext)
                     for _ in range(ln))


class ByteArrayStopCodec(Codec):
    def __init__(self, stop: int, cid: int):
        self.stop = stop
        self.cid = cid

    def decode_bytes(self, core, ext, n=None):
        r = ext[self.cid]
        end = r.b.find(bytes([self.stop]), r.pos)
        if end < 0:
            end = len(r.b)
        out = r.b[r.pos : end]
        r.pos = end + 1
        return out


def _read_encoding(r: ByteReader) -> Optional[Codec]:
    codec_id = r.itf8()
    nbytes = r.itf8()
    sub = ByteReader(r.read(nbytes))
    if codec_id == 0:           # NULL
        return None
    if codec_id == 1:           # EXTERNAL
        return ExternalCodec(sub.itf8())
    if codec_id == 3:           # HUFFMAN
        n = sub.itf8()
        alphabet = [sub.itf8() for _ in range(n)]
        n2 = sub.itf8()
        lengths = [sub.itf8() for _ in range(n2)]
        return HuffmanCodec(alphabet, lengths)
    if codec_id == 4:           # BYTE_ARRAY_LEN
        lc = _read_encoding(sub)
        vc = _read_encoding(sub)
        return ByteArrayLenCodec(lc, vc)
    if codec_id == 5:           # BYTE_ARRAY_STOP
        stop = sub.u8()
        return ByteArrayStopCodec(stop, sub.itf8())
    if codec_id == 6:           # BETA
        off = sub.itf8()
        return BetaCodec(off, sub.itf8())
    if codec_id == 9:           # GAMMA
        return GammaCodec(sub.itf8())
    raise ValueError(f"unsupported CRAM codec id {codec_id}")


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

@dataclass
class CompHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    rr: bool = True
    subst: Optional[bytes] = None          # 5-byte SM matrix
    tag_dict: List[List[Tuple[str, str]]] = field(default_factory=list)
    ds: Dict[str, Codec] = field(default_factory=dict)
    tags: Dict[int, Codec] = field(default_factory=dict)


_SUB_ORDER = "ACGTN"
# for each reference base, the 4 substitution targets in base order
_SUB_TARGETS = {
    "A": "CGTN", "C": "AGTN", "G": "ACTN", "T": "ACGN", "N": "ACGT",
}


def _parse_comp_header(data: bytes) -> CompHeader:
    r = ByteReader(data)
    ch = CompHeader()
    # preservation map
    size = r.itf8()
    pm = ByteReader(r.read(size))
    n = pm.itf8()
    for _ in range(n):
        key = pm.read(2).decode()
        if key == "RN":
            ch.rn_preserved = bool(pm.u8())
        elif key == "AP":
            ch.ap_delta = bool(pm.u8())
        elif key == "RR":
            ch.rr = bool(pm.u8())
        elif key == "SM":
            ch.subst = pm.read(5)
        elif key == "TD":
            ln = pm.itf8()
            blob = pm.read(ln)
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                    else blob.split(b"\x00"):
                tags = []
                for i in range(0, len(line), 3):
                    t = line[i : i + 3]
                    if len(t) == 3:
                        tags.append((t[:2].decode(), chr(t[2])))
                ch.tag_dict.append(tags)
        else:
            raise ValueError(f"unknown preservation key {key}")
    # data series encodings
    size = r.itf8()
    dm = ByteReader(r.read(size))
    n = dm.itf8()
    for _ in range(n):
        key = dm.read(2).decode()
        ch.ds[key] = _read_encoding(dm)
    # tag encodings
    size = r.itf8()
    tm = ByteReader(r.read(size))
    n = tm.itf8()
    for _ in range(n):
        key = tm.itf8()
        ch.tags[key] = _read_encoding(tm)
    return ch


# ---------------------------------------------------------------------------
# substitution matrix
# ---------------------------------------------------------------------------

def _subst_table(sm: Optional[bytes]) -> Dict[Tuple[str, int], str]:
    """(ref_base, code) → read base.  SM packs, per reference base, the
    2-bit code of each substitution target in target order."""
    table: Dict[Tuple[str, int], str] = {}
    if sm is None:
        sm = bytes([0x1B] * 5)  # identity-ish fallback
    for bi, ref in enumerate(_SUB_ORDER):
        byte = sm[bi]
        targets = _SUB_TARGETS[ref]
        for ti, tgt in enumerate(targets):
            code = (byte >> (6 - 2 * ti)) & 0x3
            table[(ref, code)] = tgt
    return table


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

@dataclass
class _RawRec:
    """Intermediate record before mate linkage."""

    bf: int = 0
    cf: int = 0
    ref_id: int = -1
    rlen: int = 0
    pos: int = -1            # 1-based like the stream
    rg: int = -1
    name: bytes = b""
    mate_flags: int = 0
    mate_ref: int = -1
    mate_pos: int = 0        # 1-based
    tlen: int = 0
    nf: int = -1
    tags: List[Tuple[str, str, object]] = field(default_factory=list)
    mq: int = 0
    seq: str = "*"
    qual: str = "*"
    cigar: List[Tuple[int, int]] = field(default_factory=list)
    detached: bool = False


class CRAMReader:
    """Iterate SAMRecords from a CRAM 3.0 file.

    ``reference`` (FASTA path) is required unless every slice embeds its
    reference or the file was written referenceless (RR=false); a
    missing-but-required reference raises (htslib fails the same way).
    ``allow_missing_ref=True`` opts back into decoding with match bases
    as 'N' (tag/flag inspection without the FASTA)."""

    def __init__(self, path: str, reference: Optional[str] = None,
                 allow_missing_ref: bool = False):
        self.allow_missing_ref = allow_missing_ref
        self.fh = open(path, "rb")
        magic = self.fh.read(4)
        if magic != CRAM_MAGIC:
            raise ValueError("not a CRAM file")
        self.major = self.fh.read(1)[0]
        self.minor = self.fh.read(1)[0]
        if self.major != 3:
            raise ValueError(f"unsupported CRAM version {self.major}")
        self.fh.read(20)  # file id
        # first container: SAM header
        hc = _read_container_header(self.fh, 3)
        end = self.fh.tell() + hc.length
        blk = _read_block(self.fh, 3)
        r = ByteReader(blk.data)
        hlen = r.i32()
        text = r.read(hlen).rstrip(b"\x00").decode()
        self.fh.seek(end)
        refs = []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                f = dict(x.split(":", 1) for x in line.split("\t")[1:]
                         if ":" in x)
                refs.append((f.get("SN", "?"), int(f.get("LN", 0))))
        self.header = SAMHeader(text=text, refs=refs)
        self._rg_ids: List[str] = [
            dict(x.split(":", 1) for x in line.split("\t")[1:]
                 if ":" in x).get("ID", "")
            for line in text.splitlines() if line.startswith("@RG")
        ]
        self._fa = None
        if reference is not None:
            from .fasta import FastaFile

            self._fa = FastaFile(reference)
        self._ref_cache: Dict[int, np.ndarray] = {}
        from collections import deque

        self._queue: "deque[SAMRecord]" = deque()

    # -- reference access ---------------------------------------------------
    def _ref_seq(self, rid: int) -> Optional[str]:
        if rid < 0:
            return None
        if rid not in self._ref_cache:
            if self._fa is None:
                return None
            from .fasta import decode_bases

            enc = self._fa.fetch_encoded(self.header.refs[rid][0])
            self._ref_cache[rid] = decode_bases(enc).decode()
        return self._ref_cache[rid]

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        while True:
            if self._queue:
                yield self._queue.popleft()
                continue
            try:
                self._read_container()
            except EOFError:
                return

    def close(self):
        self.fh.close()
        if self._fa is not None:
            self._fa.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- container / slice decode ------------------------------------------
    def _read_container(self):
        hc = _read_container_header(self.fh, 3)
        if hc.ref_id == -1 and hc.n_blocks == 0 and hc.length in (0, 15):
            raise EOFError  # EOF container
        body_start = self.fh.tell()
        body = self.fh.read(hc.length)
        if hc.n_records == 0 and hc.n_blocks <= 1:
            return
        bfh = io.BytesIO(body)
        comp_blk = _read_block(bfh, 3)
        if comp_blk.content_type != CT_COMP_HEADER:
            return
        ch = _parse_comp_header(comp_blk.data)
        # slices at landmarks
        for lm in hc.landmarks:
            bfh.seek(lm)
            sl_blk = _read_block(bfh, 3)
            if sl_blk.content_type != CT_SLICE_HEADER:
                continue
            self._decode_slice(ch, sl_blk.data, bfh, hc)

    def _decode_slice(self, ch: CompHeader, sh_data: bytes, bfh,
                      hc: ContainerHeader):
        r = ByteReader(sh_data)
        s_ref = r.itf8()
        s_start = r.itf8()
        s_span = r.itf8()
        n_rec = r.itf8()
        _counter = r.ltf8()
        n_blocks = r.itf8()
        n_ids = r.itf8()
        _ids = [r.itf8() for _ in range(n_ids)]
        embed_ref_id = r.itf8()
        r.read(16)  # MD5
        core: Optional[BitReader] = None
        ext: Dict[int, ByteReader] = {}
        embedded_ref: Optional[bytes] = None
        for _ in range(n_blocks):
            blk = _read_block(bfh, 3)
            if blk.content_type == CT_CORE:
                core = BitReader(blk.data)
            elif blk.content_type == CT_EXTERNAL:
                ext[blk.content_id] = ByteReader(blk.data)
                if blk.content_id == embed_ref_id and embed_ref_id >= 0:
                    embedded_ref = blk.data
        subst = _subst_table(ch.subst)
        recs: List[_RawRec] = []
        prev_pos = s_start
        for _ in range(n_rec):
            rec = self._decode_record(
                ch, core, ext, s_ref, prev_pos, subst,
                embedded_ref, s_start)
            if ch.ap_delta:
                prev_pos = rec.pos
            recs.append(rec)
        self._link_mates(recs)
        self._emit(recs)

    # -- one record ---------------------------------------------------------
    def _ds_int(self, ch, key, core, ext, default=0):
        c = ch.ds.get(key)
        if c is None:
            return default
        return c.decode_int(core, ext)

    def _ds_byte(self, ch, key, core, ext, default=0):
        c = ch.ds.get(key)
        if c is None:
            return default
        return c.decode_byte(core, ext)

    def _ds_bytes(self, ch, key, core, ext, n=None):
        c = ch.ds.get(key)
        if c is None:
            return b""
        if isinstance(c, ExternalCodec):
            return c.decode_bytes(core, ext, n)
        return c.decode_bytes(core, ext, n)

    def _decode_record(self, ch, core, ext, s_ref, prev_pos, subst,
                       embedded_ref, s_start) -> _RawRec:
        rec = _RawRec()
        rec.bf = self._ds_int(ch, "BF", core, ext)
        rec.cf = self._ds_int(ch, "CF", core, ext)
        rec.ref_id = (self._ds_int(ch, "RI", core, ext)
                      if s_ref == -2 else s_ref)
        rec.rlen = self._ds_int(ch, "RL", core, ext)
        ap = self._ds_int(ch, "AP", core, ext)
        rec.pos = (prev_pos + ap) if ch.ap_delta else ap
        rec.rg = self._ds_int(ch, "RG", core, ext, default=-1)
        if ch.rn_preserved:
            rec.name = self._ds_bytes(ch, "RN", core, ext)
        if rec.cf & CF_DETACHED:
            rec.detached = True
            rec.mate_flags = self._ds_int(ch, "MF", core, ext)
            # restore the mate bits MF carries for detached records
            # (cram_decode.c:2101-2109: CRAM_M_REVERSE=1 → 0x1|0x20,
            # CRAM_M_UNMAP=2 → 0x8; unpaired records drop the mate ref)
            if rec.mate_flags & 0x1:
                rec.bf |= _FPAIRED | _FMREVERSE
            if rec.mate_flags & 0x2:
                rec.bf |= _FMUNMAP
            if not ch.rn_preserved:
                rec.name = self._ds_bytes(ch, "RN", core, ext)
            rec.mate_ref = self._ds_int(ch, "NS", core, ext)
            rec.mate_pos = self._ds_int(ch, "NP", core, ext)
            rec.tlen = self._ds_int(ch, "TS", core, ext)
            if not rec.bf & _FPAIRED:
                rec.mate_ref = -1
        elif rec.cf & CF_MATE_DOWNSTREAM:
            rec.nf = self._ds_int(ch, "NF", core, ext)
        # tags
        tl = self._ds_int(ch, "TL", core, ext)
        if 0 <= tl < len(ch.tag_dict):
            for tag, typ in ch.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                codec = ch.tags.get(key)
                if codec is None:
                    continue
                raw = codec.decode_bytes(core, ext)
                rec.tags.append(_decode_tag_value(tag, typ, raw))
        if not rec.bf & _FUNMAP:
            self._decode_mapped(ch, core, ext, rec, subst, embedded_ref,
                                s_start)
        else:
            self._decode_unmapped(ch, core, ext, rec)
        return rec

    def _decode_mapped(self, ch, core, ext, rec, subst, embedded_ref,
                       s_start):
        nfeat = self._ds_int(ch, "FN", core, ext)
        feats = []
        fpos = 0
        for _ in range(nfeat):
            code = chr(self._ds_byte(ch, "FC", core, ext))
            fpos += self._ds_int(ch, "FP", core, ext)
            if code == "X":
                feats.append((fpos, "X", self._ds_int(ch, "BS", core, ext)))
            elif code == "S":
                feats.append((fpos, "S",
                              self._ds_bytes(ch, "SC", core, ext)))
            elif code == "I":
                feats.append((fpos, "I",
                              self._ds_bytes(ch, "IN", core, ext)))
            elif code == "i":
                feats.append((fpos, "i", self._ds_byte(ch, "BA", core, ext)))
            elif code == "D":
                feats.append((fpos, "D", self._ds_int(ch, "DL", core, ext)))
            elif code == "N":
                feats.append((fpos, "N", self._ds_int(ch, "RS", core, ext)))
            elif code == "P":
                feats.append((fpos, "P", self._ds_int(ch, "PD", core, ext)))
            elif code == "H":
                feats.append((fpos, "H", self._ds_int(ch, "HC", core, ext)))
            elif code == "B":
                b = self._ds_byte(ch, "BA", core, ext)
                q = self._ds_byte(ch, "QS", core, ext)
                feats.append((fpos, "B", (b, q)))
            elif code == "b":
                feats.append((fpos, "b",
                              self._ds_bytes(ch, "BB", core, ext)))
            elif code == "q":
                feats.append((fpos, "q",
                              self._ds_bytes(ch, "QQ", core, ext)))
            elif code == "Q":
                feats.append((fpos, "Q", self._ds_byte(ch, "QS", core, ext)))
            else:
                raise ValueError(f"unknown feature code {code!r}")
        rec.mq = self._ds_int(ch, "MQ", core, ext)
        quals = None
        if rec.cf & CF_QS_PRESERVED:
            quals = bytearray(self._ds_bytes(ch, "QS", core, ext, rec.rlen))
        # fail loudly like htslib when the slice needs a reference none
        # was given (ADVICE r4: silently filling every match base with
        # 'N' wrote corrupted BAMs from `sv -B sample.cram` without -R)
        if (not self.allow_missing_ref
                and getattr(ch, "rr", True) and embedded_ref is None
                and rec.ref_id >= 0 and rec.rlen
                and not (rec.cf & CF_NO_SEQ)
                and self._ref_seq(rec.ref_id) is None):
            raise ValueError(
                "CRAM input requires a reference: the compression header "
                "says reference-required (RR=true) and the slice embeds "
                "none — pass -R/--reference with the FASTA the CRAM was "
                "written against")
        self._reconstruct(rec, feats, subst, embedded_ref, s_start, quals)

    def _decode_unmapped(self, ch, core, ext, rec):
        bases = bytearray()
        ba = ch.ds.get("BA")
        for _ in range(rec.rlen):
            bases.append(ba.decode_byte(core, ext) if ba else ord("N"))
        rec.seq = bases.decode()
        if rec.cf & CF_QS_PRESERVED:
            q = self._ds_bytes(ch, "QS", core, ext, rec.rlen)
            rec.qual = "".join(chr(min(x, 93) + 33) for x in q)
        rec.cigar = []

    def _reconstruct(self, rec, feats, subst, embedded_ref, s_start,
                     quals):
        """Rebuild SEQ + CIGAR from reference and features."""
        ref = None
        if embedded_ref is not None:
            ref = embedded_ref.decode("latin-1")
            ref_off = s_start - 1
        else:
            ref = self._ref_seq(rec.ref_id)
            ref_off = 0
        # SEQ=* records (secondary/supplementary without stored bases):
        # features still define the cigar, but there are no bases to fill
        noseq = bool(rec.cf & CF_NO_SEQ) or rec.rlen == 0
        seq = [""] * rec.rlen
        cigar: List[Tuple[int, int]] = []

        def add_op(op, ln):
            if ln <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))

        def put(q, c):
            if not noseq and 0 <= q < rec.rlen:
                seq[q] = c

        rpos = rec.pos - 1          # 0-based reference cursor
        qpos = 0                    # 0-based read cursor
        for fp, code, val in feats:   # decode order; fp non-decreasing
            f0 = fp - 1             # feature pos is 1-based in-read
            # match-copy up to the feature
            gap = f0 - qpos
            if gap > 0:
                for i in range(gap):
                    put(qpos + i,
                        ref[rpos - ref_off + i]
                        if ref and 0 <= rpos - ref_off + i < len(ref)
                        else "N")
                add_op(0, gap)
                rpos += gap
                qpos += gap
            if code == "X":
                rb = (ref[rpos - ref_off]
                      if ref and 0 <= rpos - ref_off < len(ref) else "N")
                put(qpos, subst.get((rb.upper(), val), "N"))
                add_op(0, 1)
                rpos += 1
                qpos += 1
            elif code == "S":
                sv = val.decode()
                for i, c in enumerate(sv):
                    put(qpos + i, c)
                add_op(4, len(sv))
                qpos += len(sv)
            elif code == "I":
                sv = val.decode()
                for i, c in enumerate(sv):
                    put(qpos + i, c)
                add_op(1, len(sv))
                qpos += len(sv)
            elif code == "i":
                put(qpos, chr(val))
                add_op(1, 1)
                qpos += 1
            elif code == "D":
                add_op(2, val)
                rpos += val
            elif code == "N":
                add_op(3, val)
                rpos += val
            elif code == "P":
                add_op(6, val)
            elif code == "H":
                add_op(5, val)
            elif code == "B":
                put(qpos, chr(val[0]))
                if quals is not None and qpos < len(quals):
                    quals[qpos] = val[1]
                add_op(0, 1)
                rpos += 1
                qpos += 1
            elif code == "b":
                sv = val.decode()
                for i, c in enumerate(sv):
                    put(qpos + i, c)
                add_op(0, len(sv))
                rpos += len(sv)
                qpos += len(sv)
            elif code == "q":
                if quals is not None:
                    for i, qv in enumerate(val):
                        if fp - 1 + i < len(quals):
                            quals[fp - 1 + i] = qv
            elif code == "Q":
                if quals is not None and fp - 1 < len(quals):
                    quals[fp - 1] = val
        tail = rec.rlen - qpos
        if tail > 0:
            for i in range(tail):
                put(qpos + i,
                    ref[rpos - ref_off + i]
                    if ref and 0 <= rpos - ref_off + i < len(ref) else "N")
            add_op(0, tail)
        rec.seq = "".join(seq) if (rec.rlen and not noseq) else "*"
        rec.cigar = cigar
        if quals is not None and not noseq:
            rec.qual = "".join(chr(min(x, 93) + 33) for x in quals)
        else:
            rec.qual = "*"

    # -- mate linkage -------------------------------------------------------
    def _link_mates(self, recs: List[_RawRec]):
        for i, rec in enumerate(recs):
            if rec.nf < 0:
                continue
            j = i + rec.nf + 1
            if j >= len(recs):
                continue
            mate = recs[j]
            mate.name = rec.name
            # flags
            rec.bf |= _FPAIRED
            mate.bf |= _FPAIRED
            if mate.bf & _FREVERSE:
                rec.bf |= _FMREVERSE
            if mate.bf & _FUNMAP:
                rec.bf |= _FMUNMAP
            if rec.bf & _FREVERSE:
                mate.bf |= _FMREVERSE
            if rec.bf & _FUNMAP:
                mate.bf |= _FMUNMAP
            rec.mate_ref = mate.ref_id
            rec.mate_pos = mate.pos
            mate.mate_ref = rec.ref_id
            mate.mate_pos = rec.pos
            # TLEN per the spec: outermost span, sign by leftmost
            e1 = rec.pos - 1 + max(cigar_ref_len(rec.cigar), 1)
            e2 = mate.pos - 1 + max(cigar_ref_len(mate.cigar), 1)
            lo = min(rec.pos - 1, mate.pos - 1)
            hi = max(e1, e2)
            tlen = hi - lo
            if rec.pos - 1 < mate.pos - 1 or (
                    rec.pos == mate.pos and rec.nf >= 0):
                rec.tlen, mate.tlen = tlen, -tlen
            else:
                rec.tlen, mate.tlen = -tlen, tlen

    def _emit(self, recs: List[_RawRec]):
        for rec in recs:
            tags = list(rec.tags)
            if 0 <= rec.rg < len(self._rg_ids):
                tags.append(("RG", "Z", self._rg_ids[rec.rg]))
            self._queue.append(SAMRecord(
                qname=rec.name.decode() if rec.name else "*",
                flag=rec.bf,
                tid=rec.ref_id,
                pos=rec.pos - 1,
                mapq=rec.mq,
                cigar=rec.cigar,
                mtid=rec.mate_ref,
                mpos=rec.mate_pos - 1,
                tlen=rec.tlen,
                seq=rec.seq,
                qual=rec.qual,
                tags=tags,
            ))


def _decode_tag_value(tag: str, typ: str, raw: bytes):
    """Aux value bytes (BAM encoding) → (tag, type, value)."""
    if typ == "Z" or typ == "H":
        return (tag, typ, raw.rstrip(b"\x00").decode())
    if typ == "A":
        return (tag, "A", chr(raw[0]))
    if typ in "cC":
        v = raw[0]
        if typ == "c" and v >= 128:
            v -= 256
        return (tag, "i", v)
    if typ in "sS":
        v = struct.unpack("<H" if typ == "S" else "<h", raw[:2])[0]
        return (tag, "i", v)
    if typ in "iI":
        v = struct.unpack("<I" if typ == "I" else "<i", raw[:4])[0]
        return (tag, "i", v)
    if typ == "f":
        return (tag, "f", struct.unpack("<f", raw[:4])[0])
    if typ == "B":
        sub = chr(raw[0])
        (n,) = struct.unpack("<i", raw[1:5])
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}[sub]
        vals = list(struct.unpack(f"<{n}{fmt}", raw[5 : 5 + n *
                                                    struct.calcsize(fmt)]))
        return (tag, "B", (sub, vals))
    return (tag, typ, raw)


def read_cram(path: str, reference: Optional[str] = None,
              allow_missing_ref: bool = False,
              ) -> Tuple[SAMHeader, List[SAMRecord]]:
    with CRAMReader(path, reference,
                    allow_missing_ref=allow_missing_ref) as r:
        return r.header, list(r)


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == CRAM_MAGIC


def cram_to_bam(cram_path: str, bam_path: str,
                reference: Optional[str] = None) -> str:
    """Decode a CRAM into a BAM (the reference's sv CRAM support decodes
    to alignment streams the same way; all downstream stages are
    BAM-native here)."""
    from .bam import BAMWriter

    with CRAMReader(cram_path, reference) as rd:
        with BAMWriter(bam_path, rd.header) as w:
            for rec in rd:
                w.write(rec)
    return bam_path
