"""The port's native host runtime: csrc/ssq_native.cc through ctypes.

The reference's host-side hot loops are native C (htslib BGZF deflate +
bgzf_mt thread pool, bgzf.c:781-812; bam_write1/bam_read1 record codec,
sam.c:407,443).  This package exposes the C++ re-implementations with the
same byte-level behavior.  The port requires them: its BGZF, BAM, BAI,
align-epilogue, var and sv host layers call in here and have no other
path.

The shared object is compiled with g++ against zlib at first use
(importing the package compiles nothing) and cached next to the source,
keyed by a source hash: no pip/pybind11 required (C ABI + ctypes).  A
build or load that fails raises RuntimeError, naming the g++ command and
ending with the compiler's error; the failure is remembered, so later
calls raise it again without building.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

# Source ships inside the package (package-data) so installed wheels keep
# the native runtime; build cache lives next to it when writable, else in
# the user cache dir (site-packages is often read-only).
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "ssq_native.cc")


def _build_dir() -> str:
    cand = os.path.join(_PKG_DIR, "build")
    try:
        os.makedirs(cand, exist_ok=True)
        probe = os.path.join(cand, f".w.{os.getpid()}")
        with open(probe, "w"):
            pass
        os.unlink(probe)
        return cand
    except OSError:
        cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache")
        return os.path.join(cache, "speedseq_tpu_torch", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None     # the first build or load failure

_i64 = ctypes.c_int64
_p8 = ctypes.POINTER(ctypes.c_uint8)


def _np_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _build() -> str:
    """Path of the library built from _SRC, compiled when the cache lacks
    it; RuntimeError naming the g++ command and ending with its error."""
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        bdir = _build_dir()
        so = os.path.join(bdir, f"libssq_native-{digest}.so")
        if os.path.exists(so):
            return so
        os.makedirs(bdir, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f"the native host runtime did not build: {e}") from e
    tmp = so + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        err = getattr(e, "stderr", None)
        detail = err.decode(errors="replace").strip() if err else str(e)
        raise RuntimeError("the native host runtime did not build: "
                           f"{' '.join(cmd)}\n{detail}") from e
    return so


def load() -> ctypes.CDLL:
    """The native library, built and loaded once, at first use; raises
    RuntimeError when it does not build or load (and, the failure
    remembered, on every later call)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _declare(_build())
            except RuntimeError as e:
                _error = str(e)
        if _error is not None:
            raise RuntimeError(_error)
        return _lib


def _declare(so: str) -> ctypes.CDLL:
    """The library at ``so`` with every entry's argtypes and restype."""
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(
            f"the native host runtime did not load: {so}\n{e}") from e
    lib.ssq_version.restype = ctypes.c_int
    lib.ssq_bgzf_compress_bound.restype = _i64
    lib.ssq_bgzf_compress_bound.argtypes = [_i64]
    lib.ssq_bgzf_compress.restype = _i64
    lib.ssq_bgzf_compress.argtypes = [
        _p8, _i64, ctypes.c_int, ctypes.c_int, _p8, _i64, ctypes.c_int]
    lib.ssq_bgzf_scan.restype = _i64
    lib.ssq_bgzf_scan.argtypes = [
        _p8, _i64, ctypes.POINTER(_i64), ctypes.POINTER(_i64),
        ctypes.POINTER(_i64), _i64]
    lib.ssq_bgzf_decompress.restype = _i64
    lib.ssq_bgzf_decompress.argtypes = [
        _p8, ctypes.POINTER(_i64), ctypes.POINTER(_i64),
        ctypes.POINTER(_i64), ctypes.POINTER(_i64), _i64, ctypes.c_int,
        _p8, _i64]
    lib.ssq_bam_encode_size.restype = _i64
    lib.ssq_bam_encode_size.argtypes = [_i64] + [ctypes.POINTER(_i64)] * 4
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    _pu16 = ctypes.POINTER(ctypes.c_uint16)
    _pu32 = ctypes.POINTER(ctypes.c_uint32)
    _pi64 = ctypes.POINTER(_i64)
    lib.ssq_bam_encode.restype = _i64
    lib.ssq_bam_encode.argtypes = [
        _i64, _pi32, _pi32, _pi32, _p8, _pu16, _pi32, _pi32, _pi32,
        _p8, _pi64, _pu32, _pi64, _p8, _p8, _pi64, _p8, _pi64, _p8, _i64]
    lib.ssq_bam_scan.restype = _i64
    lib.ssq_bam_scan.argtypes = [_p8, _i64, _pi64]
    lib.ssq_bam_decode.restype = _i64
    lib.ssq_bam_decode.argtypes = [
        _p8, _i64, _pi32, _pi32, _p8, _pu16, _pi32, _pi32, _pi32,
        _p8, _pi64, _pu32, _pi64, _p8, _p8, _pi64, _p8, _pi64]
    lib.ssq_cigar_strings.restype = _i64
    lib.ssq_cigar_strings.argtypes = [_i64, _pu32, _pi64, _p8, _i64, _pi64]
    lib.ssq_build_aux.restype = _i64
    lib.ssq_build_aux.argtypes = [
        _i64, _pi32, _pi32, _pi32, _pi32, _pi32, _p8, _pi64,
        _p8, _pi64, _p8, _pi64, _p8, _i64, _pi64]
    lib.ssq_gather_records.restype = _i64
    lib.ssq_gather_records.argtypes = [
        _p8, _pi64, _pi64, _pi64, _i64, _p8, _i64]
    lib.ssq_find_ztag.restype = _i64
    lib.ssq_find_ztag.argtypes = [
        _p8, _pi64, _i64, ctypes.c_uint8, ctypes.c_uint8, _pi64, _pi64]
    lib.ssq_cigar_str_reflen.restype = _i64
    lib.ssq_cigar_str_reflen.argtypes = [_p8, _pi64, _pi64, _i64, _pi32]
    _pi8 = ctypes.POINTER(ctypes.c_int8)
    lib.ssq_pileup_expand.restype = _i64
    lib.ssq_pileup_expand.argtypes = [
        _i64, _pi64, _pi64, _p8, _p8, _pu32, _pi64, _pi64, _pi64,
        _pi64, _pi8, _i64, _i64, _i64,
        _pi8, _pi8, _pi32, _pi32, _pi32, _pi32]
    lib.ssq_bgzf_whole.restype = _i64
    lib.ssq_bgzf_whole.argtypes = [_p8, _i64]
    lib.ssq_bam_whole.restype = _i64
    lib.ssq_bam_whole.argtypes = [_p8, _i64, ctypes.c_uint16, _pi64]
    lib.ssq_bam_reads.restype = _i64
    lib.ssq_bam_reads.argtypes = [
        _p8, _i64, ctypes.c_uint16, ctypes.c_uint16, _i64, _i64, _p8, _p8,
        _pi32, _pu16, _pi64, _pi64, _pi64, _pi64]
    return lib


def default_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def bgzf_compress(data: bytes, level: int = 6, add_eof: bool = True,
                  nthreads: Optional[int] = None) -> bytes:
    """Whole-buffer multithreaded BGZF compression (bgzf_mt equivalent).

    Byte-identical to the Python formats.bgzf writer at the same level.
    """
    lib = load()
    nt = nthreads or default_threads()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.ssq_bgzf_compress_bound(len(data))
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.ssq_bgzf_compress(
        _np_ptr(src, ctypes.c_uint8) if len(data) else _p8(),
        len(data), level, nt, _np_ptr(dst, ctypes.c_uint8), cap,
        1 if add_eof else 0)
    if n < 0:
        raise ValueError("native BGZF compression failed")
    return dst[:n].tobytes()


def bgzf_decompress(data: bytes, nthreads: Optional[int] = None) -> bytes:
    """Whole-buffer parallel BGZF decompression (with CRC verification)."""
    lib = load()
    nt = nthreads or default_threads()
    src = np.frombuffer(data, dtype=np.uint8)
    max_blocks = max(1, len(data) // 64 + 16)
    while True:
        co = np.empty(max_blocks, dtype=np.int64)
        bs = np.empty(max_blocks, dtype=np.int64)
        iz = np.empty(max_blocks, dtype=np.int64)
        n = lib.ssq_bgzf_scan(
            _np_ptr(src, ctypes.c_uint8) if len(data) else _p8(), len(data),
            _np_ptr(co, _i64), _np_ptr(bs, _i64), _np_ptr(iz, _i64),
            max_blocks)
        if n == -1:
            raise ValueError("malformed BGZF input")
        if n < -1:
            max_blocks = -(n + 2)
            continue
        break
    nblocks = int(n)
    co, bs, iz = co[:nblocks], bs[:nblocks], iz[:nblocks]
    uoff = np.zeros(nblocks, dtype=np.int64)
    if nblocks > 1:
        np.cumsum(iz[:-1], out=uoff[1:])
    total = int(uoff[-1] + iz[-1]) if nblocks else 0
    dst = np.empty(max(total, 1), dtype=np.uint8)
    got = lib.ssq_bgzf_decompress(
        _np_ptr(src, ctypes.c_uint8) if len(data) else _p8(),
        _np_ptr(co, _i64), _np_ptr(bs, _i64), _np_ptr(uoff, _i64),
        _np_ptr(iz, _i64), nblocks, nt, _np_ptr(dst, ctypes.c_uint8),
        len(dst))
    if got < 0:
        raise ValueError("native BGZF decompression failed (CRC?)")
    return dst[:got].tobytes()


class BamColumns:
    """Columnar batch of BAM records (struct-of-arrays, bam1_t fields)."""

    __slots__ = ("tid", "pos", "ref_end", "mapq", "flag", "mtid", "mpos",
                 "tlen", "qname_blob", "qname_off", "cigar_blob", "cigar_off",
                 "seq_blob", "qual_blob", "seq_off", "aux_blob", "aux_off")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @property
    def n(self) -> int:
        return len(self.tid)


def bam_encode(c: "BamColumns") -> bytes:
    """Columnar → concatenated block_size-prefixed BAM records."""
    lib = load()
    n = c.n
    size = lib.ssq_bam_encode_size(
        n, _np_ptr(c.qname_off, _i64), _np_ptr(c.cigar_off, _i64),
        _np_ptr(c.seq_off, _i64), _np_ptr(c.aux_off, _i64))
    dst = np.empty(max(int(size), 1), dtype=np.uint8)
    got = lib.ssq_bam_encode(
        n,
        _np_ptr(c.tid, ctypes.c_int32), _np_ptr(c.pos, ctypes.c_int32),
        _np_ptr(c.ref_end, ctypes.c_int32),
        _np_ptr(c.mapq, ctypes.c_uint8), _np_ptr(c.flag, ctypes.c_uint16),
        _np_ptr(c.mtid, ctypes.c_int32), _np_ptr(c.mpos, ctypes.c_int32),
        _np_ptr(c.tlen, ctypes.c_int32),
        _np_ptr(c.qname_blob, ctypes.c_uint8), _np_ptr(c.qname_off, _i64),
        _np_ptr(c.cigar_blob, ctypes.c_uint32), _np_ptr(c.cigar_off, _i64),
        _np_ptr(c.seq_blob, ctypes.c_uint8), _np_ptr(c.qual_blob, ctypes.c_uint8),
        _np_ptr(c.seq_off, _i64),
        _np_ptr(c.aux_blob, ctypes.c_uint8), _np_ptr(c.aux_off, _i64),
        _np_ptr(dst, ctypes.c_uint8), len(dst))
    if got < 0:
        raise ValueError("native BAM encode overflow")
    return dst[:got].tobytes()


_AUX_ABSENT = np.int32(-2**31)  # sentinel shared with ssq_build_aux


def pileup_expand(pos, seq_off, seq_blob, qual_blob, cigar_blob,
                  cig_lo, cig_hi, rstart, base_idx, strand,
                  start: int, end: int, min_baseq: int,
                  flat_proj, flat_qual, flat_rpos,
                  base_counts, qual_sums, strand_counts) -> int:
    """One-pass pileup expansion (see ssq_pileup_expand): fills the
    span-compact flat layout + count matrices in place."""
    lib = load()
    return lib.ssq_pileup_expand(
        len(pos), _np_ptr(pos, _i64), _np_ptr(seq_off, _i64),
        _np_ptr(seq_blob, ctypes.c_uint8), _np_ptr(qual_blob, ctypes.c_uint8),
        _np_ptr(cigar_blob, ctypes.c_uint32),
        _np_ptr(cig_lo, _i64), _np_ptr(cig_hi, _i64),
        _np_ptr(rstart, _i64), _np_ptr(base_idx, _i64),
        _np_ptr(strand, ctypes.c_int8),
        start, end, min_baseq,
        _np_ptr(flat_proj, ctypes.c_int8), _np_ptr(flat_qual, ctypes.c_int8),
        _np_ptr(flat_rpos, ctypes.c_int32),
        _np_ptr(base_counts, ctypes.c_int32),
        _np_ptr(qual_sums, ctypes.c_int32),
        _np_ptr(strand_counts, ctypes.c_int32))


def cigar_strings(cigar_blob: np.ndarray, cigar_off: np.ndarray):
    """Batch cigar → ASCII (per-record); returns (blob u8, off i64 n+1)."""
    lib = load()
    n = len(cigar_off) - 1
    cap = 11 * max(int(cigar_off[-1]), 1) + 1
    dst = np.empty(cap, np.uint8)
    out_off = np.empty(n + 1, np.int64)
    got = lib.ssq_cigar_strings(
        n, _np_ptr(cigar_blob, ctypes.c_uint32), _np_ptr(cigar_off, _i64),
        _np_ptr(dst, ctypes.c_uint8), cap, _np_ptr(out_off, _i64))
    if got < 0:
        raise ValueError("cigar string overflow")
    return dst[:got], out_off


def build_aux(nm, as_, xs, mq, rg_idx, rg_blob, rg_off, mc_blob, mc_off,
              extra_blob, extra_off):
    """Batch aux-blob assembly (NM/AS/XS/RG/MC/MQ + extra raw bytes).

    Int columns use _AUX_ABSENT as the "tag not present" sentinel."""
    lib = load()
    n = len(nm)
    # bound by the *maximum* RG string (the average under-allocates when
    # a long RG ID dominates a mixed-RG batch, aborting the run with
    # 'aux blob overflow'); RG blobs are tiny, so worst-case is free
    max_rg = int(np.diff(np.asarray(rg_off)).max()) if len(rg_off) > 1 else 0
    cap = int(
        n * (3 * 7 + 4 + 4 + 7 + 2)
        + n * (max_rg + 4)
        + int(mc_off[-1]) + int(extra_off[-1]) + 64
    )
    cap += 64 * n
    dst = np.empty(cap, np.uint8)
    out_off = np.empty(n + 1, np.int64)
    got = lib.ssq_build_aux(
        n, _np_ptr(nm, ctypes.c_int32), _np_ptr(as_, ctypes.c_int32),
        _np_ptr(xs, ctypes.c_int32), _np_ptr(mq, ctypes.c_int32),
        _np_ptr(rg_idx, ctypes.c_int32), _np_ptr(rg_blob, ctypes.c_uint8),
        _np_ptr(rg_off, _i64), _np_ptr(mc_blob, ctypes.c_uint8),
        _np_ptr(mc_off, _i64), _np_ptr(extra_blob, ctypes.c_uint8),
        _np_ptr(extra_off, _i64), _np_ptr(dst, ctypes.c_uint8), cap,
        _np_ptr(out_off, _i64))
    if got < 0:
        raise ValueError("aux blob overflow")
    return dst[:got], out_off


def gather_records(blob: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
                   order: np.ndarray) -> np.ndarray:
    """Reorder concatenated BAM records in one native call."""
    lib = load()
    total = int(sizes.sum())
    dst = np.empty(max(total, 1), np.uint8)
    got = lib.ssq_gather_records(
        _np_ptr(blob, ctypes.c_uint8), _np_ptr(starts, _i64),
        _np_ptr(sizes, _i64), _np_ptr(order, _i64), len(order),
        _np_ptr(dst, ctypes.c_uint8), len(dst))
    if got < 0:
        raise ValueError("gather overflow")
    return dst[:got]


def bgzf_block_table(data: bytes):
    """(coffsets, isizes) of every BGZF block in ``data`` — the
    compressed↔uncompressed offset map (virtual-offset computation)."""
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    max_blocks = max(1, len(data) // 64 + 16)
    while True:
        co = np.empty(max_blocks, dtype=np.int64)
        bs = np.empty(max_blocks, dtype=np.int64)
        iz = np.empty(max_blocks, dtype=np.int64)
        n = lib.ssq_bgzf_scan(
            _np_ptr(src, ctypes.c_uint8) if len(data) else _p8(), len(data),
            _np_ptr(co, _i64), _np_ptr(bs, _i64), _np_ptr(iz, _i64),
            max_blocks)
        if n == -1:
            raise ValueError("malformed BGZF input")
        if n < -1:
            max_blocks = -(n + 2)
            continue
        return co[:n].copy(), iz[:n].copy()


def find_ztag(aux_blob: np.ndarray, aux_off: np.ndarray, tag: str):
    """Per-record (offset, length) span of a Z-type aux tag's value in
    aux_blob; offset -1 when absent.  Proper tag-list walk (no substring
    false positives)."""
    lib = load()
    n = len(aux_off) - 1
    out_off = np.empty(n, np.int64)
    out_len = np.empty(n, np.int64)
    lib.ssq_find_ztag(
        _np_ptr(aux_blob, ctypes.c_uint8), _np_ptr(aux_off, _i64), n,
        ord(tag[0]), ord(tag[1]), _np_ptr(out_off, _i64),
        _np_ptr(out_len, _i64))
    return out_off, out_len


def cigar_str_reflen(blob: np.ndarray, off: np.ndarray,
                     length: np.ndarray) -> np.ndarray:
    """Reference-consumed length of ASCII cigar strings at (off, len)
    spans (MC/SA tag cigars); 0 where off < 0."""
    lib = load()
    n = len(off)
    out = np.empty(n, np.int32)
    lib.ssq_cigar_str_reflen(
        _np_ptr(blob, ctypes.c_uint8), _np_ptr(off, _i64),
        _np_ptr(length, _i64), n, _np_ptr(out, ctypes.c_int32))
    return out


def bam_decode(blob: bytes) -> "BamColumns":
    """Concatenated BAM records → columnar arrays (seq back as ASCII)."""
    lib = load()
    src = np.frombuffer(blob, dtype=np.uint8)
    counts = np.zeros(5, dtype=np.int64)
    n = lib.ssq_bam_scan(
        _np_ptr(src, ctypes.c_uint8) if len(blob) else _p8(), len(blob),
        _np_ptr(counts, _i64))
    if n < 0:
        raise ValueError("malformed BAM record blob")
    n, qn, cg, sq, ax = (int(x) for x in counts)
    c = BamColumns(
        tid=np.empty(n, np.int32), pos=np.empty(n, np.int32),
        ref_end=np.empty(n, np.int32),  # not recovered by decode
        mapq=np.empty(n, np.uint8), flag=np.empty(n, np.uint16),
        mtid=np.empty(n, np.int32), mpos=np.empty(n, np.int32),
        tlen=np.empty(n, np.int32),
        qname_blob=np.empty(max(qn, 1), np.uint8),
        qname_off=np.empty(n + 1, np.int64),
        cigar_blob=np.empty(max(cg, 1), np.uint32),
        cigar_off=np.empty(n + 1, np.int64),
        seq_blob=np.empty(max(sq, 1), np.uint8),
        qual_blob=np.empty(max(sq, 1), np.uint8),
        seq_off=np.empty(n + 1, np.int64),
        aux_blob=np.empty(max(ax, 1), np.uint8),
        aux_off=np.empty(n + 1, np.int64),
    )
    got = lib.ssq_bam_decode(
        _np_ptr(src, ctypes.c_uint8) if len(blob) else _p8(), len(blob),
        _np_ptr(c.tid, ctypes.c_int32), _np_ptr(c.pos, ctypes.c_int32),
        _np_ptr(c.mapq, ctypes.c_uint8), _np_ptr(c.flag, ctypes.c_uint16),
        _np_ptr(c.mtid, ctypes.c_int32), _np_ptr(c.mpos, ctypes.c_int32),
        _np_ptr(c.tlen, ctypes.c_int32),
        _np_ptr(c.qname_blob, ctypes.c_uint8), _np_ptr(c.qname_off, _i64),
        _np_ptr(c.cigar_blob, ctypes.c_uint32), _np_ptr(c.cigar_off, _i64),
        _np_ptr(c.seq_blob, ctypes.c_uint8), _np_ptr(c.qual_blob, ctypes.c_uint8),
        _np_ptr(c.seq_off, _i64),
        _np_ptr(c.aux_blob, ctypes.c_uint8), _np_ptr(c.aux_off, _i64))
    if got != n:
        raise ValueError("native BAM decode inconsistency")
    c.ref_end[:] = 0
    return c


def bgzf_whole(data) -> int:
    """Bytes of the longest prefix of ``data`` made of whole BGZF blocks."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    got = lib.ssq_bgzf_whole(
        _np_ptr(src, ctypes.c_uint8) if len(src) else _p8(), len(src))
    if got < 0:
        raise ValueError("malformed BGZF block header")
    return int(got)


def bam_whole(src: np.ndarray, skip_mask: int) -> Tuple[int, int]:
    """(bytes, rows) of the whole records at the head of the BAM record
    stream ``src`` (u8): the rows are the records ``bam_reads`` keeps,
    those with no flag of ``skip_mask`` and a sequence."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    out = np.zeros(2, np.int64)
    got = lib.ssq_bam_whole(
        _np_ptr(src, ctypes.c_uint8) if len(src) else _p8(), len(src),
        skip_mask, _np_ptr(out, _i64))
    if got < 0:
        raise ValueError("malformed BAM record")
    return int(out[0]), int(out[1])


class BamReads(NamedTuple):
    """Reads of BAM records as padded rows (csrc ``ssq_bam_reads``)."""
    seq: np.ndarray        # (rows, max_len) u8 codes 0-4, padded with 4
    qual: np.ndarray       # (rows, max_len) u8 phred, padded with 0
    length: np.ndarray     # (rows,) i32
    flag: np.ndarray       # (rows,) u16
    qname_off: np.ndarray  # (rows,) i64 spans in the source bytes
    qname_len: np.ndarray
    rg_off: np.ndarray     # -1 without an RG:Z tag
    rg_len: np.ndarray


def bam_reads(src: np.ndarray, rows: int, skip_mask: int, turn_mask: int,
              max_len: int) -> BamReads:
    """The ``rows`` reads of ``src``, whole records that ``bam_whole``
    measured with the same ``skip_mask``: each in its original orientation
    (records with a flag of ``turn_mask`` reverse-complemented, qualities
    reversed), qualities all 0xff read 30, cut to ``max_len``."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    i64 = [np.empty(rows, np.int64) for _ in range(4)]
    r = BamReads(np.empty((rows, max_len), np.uint8),
                 np.empty((rows, max_len), np.uint8),
                 np.empty(rows, np.int32), np.empty(rows, np.uint16), *i64)
    got = lib.ssq_bam_reads(
        _np_ptr(src, ctypes.c_uint8) if len(src) else _p8(), len(src),
        skip_mask, turn_mask, max_len, rows,
        _np_ptr(r.seq, ctypes.c_uint8), _np_ptr(r.qual, ctypes.c_uint8),
        _np_ptr(r.length, ctypes.c_int32), _np_ptr(r.flag, ctypes.c_uint16),
        *(_np_ptr(a, _i64) for a in i64))
    if got != rows:
        raise ValueError("native BAM read decode inconsistency")
    return r
