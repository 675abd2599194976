"""BGZF: blocked gzip format (reader + writer).

Behavioral contract (reference: src/samtools-1.3.1/htslib-1.3.1/bgzf.c and
htslib/bgzf.h):

- each block is a complete gzip member with an extra subfield ``BC`` whose
  payload is ``BSIZE - 1`` (total compressed block length minus one,
  uint16le); header magic at bgzf.c:63.
- uncompressed payload per block is capped at ``BGZF_BLOCK_SIZE = 0xff00``
  (65,280 bytes; htslib/bgzf.h:43).
- a 28-byte EOF marker block (empty payload) terminates the file
  (bgzf.c "magic" EOF constant).
- virtual file offsets are ``coffset << 16 | uoffset`` where ``coffset`` is
  the block's compressed start offset and ``uoffset`` the offset within the
  uncompressed block (htslib/bgzf.h:187).

The writer emits one deflate stream per block with raw deflate
(wbits=-15), mirroring ``bgzf_compress``: whole blocks through the native
runtime's thread pool, the tail block through zlib here.
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Tuple

from .. import native

BGZF_BLOCK_SIZE = 0xFF00  # 65280, htslib/bgzf.h:43
_BGZF_HEADER = (
    b"\x1f\x8b\x08\x04"  # gzip magic, CM=deflate, FLG=FEXTRA
    b"\x00\x00\x00\x00"  # MTIME
    b"\x00\xff"          # XFL, OS=unknown
    b"\x06\x00"          # XLEN=6
    b"BC\x02\x00"        # extra subfield id 'BC', length 2
)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress one ≤65280-byte payload into a complete BGZF block."""
    if len(data) > BGZF_BLOCK_SIZE:
        raise ValueError("BGZF block payload too large")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + len(_BGZF_HEADER) + 2 + 8  # +BSIZE u16 +CRC/ISIZE
    if bsize > 0x10000:
        raise ValueError("compressed BGZF block exceeds 64 KiB")
    return b"".join(
        (
            _BGZF_HEADER,
            struct.pack("<H", bsize - 1),
            comp,
            struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)),
        )
    )


class BGZFWriter:
    """Streaming BGZF writer with htslib block-boundary semantics.

    Complete 65280-byte blocks are accumulated and deflated in one
    multithreaded native call (csrc/ssq_native.cc, htslib bgzf_mt
    equivalent, bgzf.c:781-812); the block split, and therefore the output
    bytes, is that of compressing one block at a time.
    """

    def __init__(self, fileobj_or_path, level: int = 6):
        # the runtime loads before the file opens: a failed build leaves
        # no output behind
        native.load()
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "wb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes emitted so far
        self.level = level
        self._closed = False

    @property
    def tell_virtual(self) -> int:
        """Current virtual file offset (coffset<<16 | uoffset)."""
        self._drain_full_blocks()
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> int:
        self._buf.extend(data)
        if len(self._buf) >= 64 * BGZF_BLOCK_SIZE:
            self._drain_full_blocks()
        return len(data)

    def flush(self) -> None:
        self._drain_full_blocks()
        while self._buf:
            self._flush_block(min(len(self._buf), BGZF_BLOCK_SIZE))

    def _drain_full_blocks(self) -> None:
        n_full = (len(self._buf) // BGZF_BLOCK_SIZE) * BGZF_BLOCK_SIZE
        if not n_full:
            return
        out = native.bgzf_compress(
            bytes(self._buf[:n_full]), level=self.level, add_eof=False)
        del self._buf[:n_full]
        self._fh.write(out)
        self._coffset += len(out)

    def _flush_block(self, n: int) -> None:
        block = _compress_block(bytes(self._buf[:n]), self.level)
        del self._buf[:n]
        self._fh.write(block)
        self._coffset += len(block)

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        self._closed = True
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class _Block:
    coffset: int
    clen: int
    data: bytes


def _read_block(fh: BinaryIO) -> Tuple[bytes, int]:
    """Read one BGZF block; returns (uncompressed payload, compressed len).

    Raises EOFError at end of file.
    """
    hdr = fh.read(12)
    if len(hdr) == 0:
        raise EOFError
    if len(hdr) < 12 or hdr[:4] != b"\x1f\x8b\x08\x04":
        raise ValueError("not a BGZF block")
    xlen = struct.unpack("<H", hdr[10:12])[0]
    extra = fh.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack(
            "<H", extra[off + 2 : off + 4]
        )[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack("<H", extra[off + 4 : off + 6])[0] + 1
        off += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC subfield")
    cdata_len = bsize - 12 - xlen - 8
    cdata = fh.read(cdata_len)
    crc, isize = struct.unpack("<II", fh.read(8))
    data = zlib.decompress(cdata, -15)
    if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
        raise ValueError("BGZF block checksum mismatch")
    return data, bsize


class BGZFReader:
    """Random-access BGZF reader (supports virtual-offset seeks)."""

    def __init__(self, fileobj_or_path):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "rb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._block = b""
        self._block_coffset = 0
        self._next_coffset = 0
        self._uoffset = 0

    def _load_block_at(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        try:
            data, clen = _read_block(self._fh)
        except EOFError:
            self._block = b""
            self._block_coffset = coffset
            self._next_coffset = coffset
            self._uoffset = 0
            return False
        self._block = data
        self._block_coffset = coffset
        self._next_coffset = coffset + clen
        self._uoffset = 0
        return True

    def seek_virtual(self, voffset: int) -> None:
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if not self._load_block_at(coffset) and uoffset:
            raise EOFError("seek past end of BGZF file")
        self._uoffset = uoffset

    @property
    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._uoffset

    def read(self, n: int = -1) -> bytes:
        out = io.BytesIO()
        while n != 0:
            avail = len(self._block) - self._uoffset
            if avail == 0:
                if not self._load_block_at(self._next_coffset):
                    break
                if not self._block:  # EOF marker block then EOF
                    continue
                avail = len(self._block)
            take = avail if n < 0 else min(avail, n)
            out.write(self._block[self._uoffset : self._uoffset + take])
            self._uoffset += take
            if n > 0:
                n -= take
        return out.getvalue()

    def read_to(self, voffset: int) -> bytes:
        """Bulk read from the current position up to virtual offset
        ``voffset`` (must be ≥ current).  One block-sized copy per block —
        the BAI region-fetch fast path (replaces per-record read loops)."""
        tc, tu = voffset >> 16, voffset & 0xFFFF
        out = io.BytesIO()
        while self._block_coffset < tc:
            avail = len(self._block) - self._uoffset
            if avail:
                out.write(self._block[self._uoffset:])
                self._uoffset = len(self._block)
            if not self._load_block_at(self._next_coffset):
                return out.getvalue()
        if self._block_coffset == tc and tu > self._uoffset:
            out.write(self._block[self._uoffset : tu])
            self._uoffset = tu
        return out.getvalue()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress(data: bytes, level: int = 6) -> bytes:
    """bgzip-equivalent: full-buffer BGZF compression incl. EOF marker."""
    return native.bgzf_compress(data, level=level, add_eof=True)


def decompress(data: bytes) -> bytes:
    """Decompress a whole BGZF byte string."""
    return native.bgzf_decompress(data)


def iter_blocks(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (coffset, payload) per block — used by index builders."""
    with open(path, "rb") as fh:
        coffset = 0
        while True:
            try:
                data, clen = _read_block(fh)
            except EOFError:
                return
            yield coffset, data
            coffset += clen


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        hdr = fh.read(18)
    return (
        len(hdr) >= 18
        and hdr[:4] == b"\x1f\x8b\x08\x04"
        and hdr[12:16] == b"BC\x02\x00"
    )
