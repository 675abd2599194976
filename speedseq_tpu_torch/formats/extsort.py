"""Bounded-memory external coordinate sort for BAM emission.

Reproduces samtools' external merge sort semantics the host-runtime way
(reference: src/samtools-1.3.1/bam_sort.c:1650-1812 — chunk → sort →
temp files → k-way heap merge, heap at bam_sort.c:109-119; sort key
``tid<<32|(pos+1)<<1|is_rev`` at bam_sort.c:1612; bounded memory contract
at bin/speedseq:248,441 ``sambamba sort -m (M-2)G``).

Design differences from the reference (TPU-host idioms, not a port):
- records arrive as whole batches from the device epilogue, so chunk
  sorting is one ``np.lexsort`` over columnar key arrays + one native
  batch encode (csrc/ssq_native.cc) — no per-record comparator calls;
- temp chunks are headerless BGZF record streams (low compression level:
  they live minutes, not years);
- the k-way merge never decodes records: sort keys are parsed straight
  from the fixed bam1_t core offsets (refID @0, pos @4, flag @14;
  htslib/sam.h:148-181) of the raw record bytes.

The in-memory fast path (everything fits in one chunk) produces output
byte-identical to a single global stable sort + write.
"""

from __future__ import annotations

import heapq
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import native
from .bam import BAMWriter
from .bgzf import BGZFReader, BGZFWriter
from .sam import FREVERSE, SAMHeader, SAMRecord

# tid for unmapped records in the sort key: sorts after every real tid
# (samtools places unmapped reads last, bam_sort.c:1612 key with tid -1
# wrapping to UINT32_MAX in the packed uint64)
_TID_UNMAPPED = 1 << 30


def _key_arrays(records: List[SAMRecord]):
    n = len(records)
    tid = np.empty(n, np.int64)
    pos = np.empty(n, np.int64)
    rev = np.empty(n, np.int64)
    for i, r in enumerate(records):
        tid[i] = r.tid if r.tid >= 0 else _TID_UNMAPPED
        pos[i] = r.pos + 1
        rev[i] = 1 if (r.flag & FREVERSE) else 0
    return tid, pos, rev


def _sort_order(records: List[SAMRecord]) -> np.ndarray:
    tid, pos, rev = _key_arrays(records)
    # lexsort is stable: insertion order breaks ties, matching a single
    # global stable sort over the whole run
    return np.lexsort((rev, pos, tid))


# packed-key unmapped sentinel: must leave (pos+1)<<1|rev headroom in int64
# (tid<<33 with tid=1<<30 would hit the sign bit); ordering is identical to
# the tuple form above (all real tids < sentinel, unmapped group last)
_TID_UNMAPPED_PACKED = 1 << 29


def packed_keys(tid: np.ndarray, pos: np.ndarray, flag: np.ndarray) -> np.ndarray:
    """samtools coordinate keys as one int64 column:
    tid<<33 | (pos+1)<<1 | is_rev (bam_sort.c:1612); unmapped last."""
    t = np.where(tid >= 0, tid.astype(np.int64),
                 np.int64(_TID_UNMAPPED_PACKED))
    rev = ((flag.astype(np.int64) & FREVERSE) != 0).astype(np.int64)
    return (t << 33) | ((pos.astype(np.int64) + 1) << 1) | rev


def _ranked(stream, rank: int):
    """(key, rank, raw) of a (key, raw) stream.  A generator expression
    over ``enumerate`` would read the rank when it runs, after the loop
    has moved on, so every stream would carry the last rank and equal
    keys would fall back to comparing record bytes."""
    for key, raw in stream:
        yield key, rank, raw


class _ChunkStream:
    """Iterates (key_tuple, raw_record_bytes) from one spilled chunk."""

    def __init__(self, path: str):
        self._r = BGZFReader(path)
        self.path = path

    def __iter__(self) -> Iterator[Tuple[Tuple[int, int, int], bytes]]:
        read = self._r.read
        unpack = struct.unpack_from
        while True:
            hdr = read(4)
            if len(hdr) < 4:
                return
            (sz,) = struct.unpack("<i", hdr)
            raw = read(sz)
            tid, pos = unpack("<ii", raw, 0)
            (flag,) = unpack("<H", raw, 14)
            yield (
                (tid if tid >= 0 else _TID_UNMAPPED, pos + 1,
                 1 if flag & FREVERSE else 0),
                raw,
            )

    def close(self):
        self._r.close()


class ExternalBAMSorter:
    """Coordinate-sorting BAM writer with bounded resident memory.

    add()/add_many() buffer records; when the buffer reaches
    ``max_records`` it is key-sorted and spilled as a temp chunk.
    close() writes the final BAM: in-memory sort if nothing spilled,
    otherwise a k-way heap merge over all chunks.
    """

    def __init__(
        self,
        path: str,
        header: SAMHeader,
        max_records: int = 200_000,
        level: int = 6,
        tmpdir: Optional[str] = None,
        chunk_level: int = 1,
        headerless: bool = False,
    ):
        """``headerless=True`` writes a BGZF stream of sorted record
        bytes with NO BAM magic/header — the per-range part format of
        the coordinate-resharded multi-host path, where process 0
        assembles the final BAM by concatenating BGZF members."""
        self.path = path
        self.header = header
        self.headerless = headerless
        self.max_records = max(1, int(max_records))
        self.level = level
        self.chunk_level = chunk_level
        self._tmpdir = tmpdir or (path + ".sorttmp")
        self._buf: List[SAMRecord] = []
        # columnar buffer: list of (keys i64, sizes i64, blob u8) batches,
        # in intake order (stable argsort preserves tie order across them)
        self._cb: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._cn = 0
        self._chunks: List[str] = []
        self._closed = False
        self.n_records = 0

    # ------------------------------------------------------------- intake
    def add(self, rec: SAMRecord) -> None:
        self._buf.append(rec)
        self.n_records += 1
        if self._buffered() >= self.max_records:
            self.spill()

    def add_many(self, recs: List[SAMRecord]) -> None:
        self._buf.extend(recs)
        self.n_records += len(recs)
        if self._buffered() >= self.max_records:
            self.spill()

    def add_columns(self, cols) -> None:
        """Columnar intake (align.emit.RecordColumns): records arrive as
        pre-encoded block_size-prefixed bytes + packed sort keys — the
        per-record SAMRecord object layer never exists on this path."""
        if cols.n == 0:
            return
        self.add_keyed_blob(cols.sort_keys(),
                            cols.record_sizes().astype(np.int64),
                            np.frombuffer(cols.encode(), np.uint8))

    def add_keyed_blob(self, keys: np.ndarray, sizes: np.ndarray,
                       blob: np.ndarray) -> None:
        """Raw columnar intake: packed sort keys + per-record sizes +
        concatenated record bytes (the exchange payload format of the
        coordinate re-shard)."""
        if len(keys) == 0:
            return
        self._flush_recs()
        self._cb.append((keys, sizes, blob))
        self._cn += len(keys)
        self.n_records += len(keys)
        if self._buffered() >= self.max_records:
            self.spill()

    def _buffered(self) -> int:
        return len(self._buf) + self._cn

    def _flush_recs(self) -> None:
        """Convert the SAMRecord buffer into one columnar batch so intake
        order (tie stability) is preserved when both APIs are used."""
        if not self._buf:
            return
        from .bam_cols import encode_batch

        blob = np.frombuffer(encode_batch(self._buf), np.uint8)
        tid, pos, rev = _key_arrays(self._buf)
        t = np.where(tid >= _TID_UNMAPPED, np.int64(_TID_UNMAPPED_PACKED), tid)
        keys = (t << 33) | (pos << 1) | rev
        # per-record sizes from the block_size prefixes
        sizes = np.empty(len(self._buf), np.int64)
        off = 0
        bv = blob.view()
        for i in range(len(self._buf)):
            sz = int(bv[off]) | (int(bv[off + 1]) << 8) \
                | (int(bv[off + 2]) << 16) | (int(bv[off + 3]) << 24)
            sizes[i] = sz + 4
            off += sz + 4
        self._cb.append((keys, sizes, blob))
        self._cn += len(self._buf)
        self._buf.clear()

    def _sorted_blob(self) -> np.ndarray:
        """Concatenate all buffered batches, stable-sort by packed key,
        and gather the record bytes in one native call."""
        self._flush_recs()
        if not self._cb:
            return np.zeros(0, np.uint8)
        keys = np.concatenate([k for k, _, _ in self._cb])
        sizes = np.concatenate([s for _, s, _ in self._cb])
        blob = np.concatenate([b for _, _, b in self._cb])
        self._cb.clear()
        self._cn = 0
        starts = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        order = np.argsort(keys, kind="stable")
        return native.gather_records(blob, starts, sizes, order)

    # -------------------------------------------------------------- spill
    def spill(self) -> None:
        """Sort + flush the current buffer to a temp chunk (also the
        checkpoint flush point: after spill, sorter state is just the
        chunk path list)."""
        if not self._buffered():
            return
        sorted_blob = self._sorted_blob()
        os.makedirs(self._tmpdir, exist_ok=True)
        cpath = os.path.join(self._tmpdir, f"chunk{len(self._chunks):05d}.bgz")
        w = BGZFWriter(cpath, level=self.chunk_level)
        w.write(sorted_blob.tobytes())
        w.close()
        self._chunks.append(cpath)

    # ----------------------------------------------------- checkpoint API
    def state(self) -> dict:
        """Resumable state (call spill() first so the buffer is empty)."""
        return {"chunks": list(self._chunks), "n_records": self.n_records}

    def restore(self, state: dict) -> None:
        self._chunks = [p for p in state["chunks"] if os.path.exists(p)]
        self.n_records = state["n_records"]

    # -------------------------------------------------------------- close
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.headerless:
            out = BGZFWriter(self.path, level=self.level)
            # a chunk stream yields records without their block_size,
            # which the part keeps as the BAM body does (the reference
            # writes them bare, so a part that spilled was unreadable)
            w_raw = lambda raw: out.write(struct.pack("<i", len(raw)) + raw)
            w_blob = lambda b: out.write(b)
            close_out = out.close
        else:
            out = BAMWriter(self.path, self.header, level=self.level)
            w_raw = out.write_raw
            w_blob = out.write_blob
            close_out = out.close
        if not self._chunks:
            # in-memory fast path
            w_blob(self._sorted_blob().tobytes())
            close_out()
            return
        self.spill()
        streams = [_ChunkStream(p) for p in self._chunks]
        # decorate with (key, chunk_idx) so equal keys resolve in
        # chunk (= insertion) order — global stability
        iters = [_ranked(s, ci) for ci, s in enumerate(streams)]
        for _key, _ci, raw in heapq.merge(*iters):
            w_raw(raw)
        close_out()
        for s in streams:
            s.close()
            try:
                os.unlink(s.path)
            except OSError:
                pass
        try:
            os.rmdir(self._tmpdir)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _BAMRecordStream:
    """Iterates (key_tuple, raw_record_bytes) from a full (headered) BAM —
    the per-part input of the multi-host merge."""

    def __init__(self, path: str):
        from .bam import BAMReader

        self._rd = BAMReader(path)
        self.header = self._rd.header
        self.path = path

    def __iter__(self):
        while True:
            got = self._rd.read_raw()
            if got is None:
                return
            raw = got[0]
            tid, pos = struct.unpack_from("<ii", raw, 0)
            (flag,) = struct.unpack_from("<H", raw, 14)
            yield (
                (tid if tid >= 0 else _TID_UNMAPPED, pos + 1,
                 1 if flag & FREVERSE else 0),
                raw,
            )

    def close(self):
        self._rd.close()


def merge_sorted_bams(parts: List[str], out_path: str, level: int = 6) -> None:
    """k-way merge of coordinate-sorted BAMs into one sorted BAM
    (sambamba/samtools merge semantics, bam_sort.c:1106 bam_merge_core2;
    used for sharded multi-host outputs).  Ties resolve in part order —
    with round-robin batch sharding that equals single-stream order."""
    streams = [_BAMRecordStream(p) for p in parts]
    header = streams[0].header
    with BAMWriter(out_path, header, level=level) as w:
        iters = [_ranked(s, pi) for pi, s in enumerate(streams)]
        write_raw = w.write_raw
        for _key, _pi, raw in heapq.merge(*iters):
            write_raw(raw)
    for s in streams:
        s.close()
