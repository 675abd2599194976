"""speedseq realign equivalent: BAM(s) → re-aligned sorted BAM triple.

Reference contract (bin/speedseq:1643-2034):
- merged clean header from the input BAMs (bamcleanheader.py, :1885)
- read groups grouped by library LB (bamlibs.py, :1895; RG synthesis when
  headers lack read groups, :1899-1911)
- per library: BAM→interleaved FASTQ (bamtofastq.py) → mbuffer → bwa mem
  -C -p → bamheadrg.py (re-inject per-read RG) → samblaster → sort
  (:1930-1973)
- outputs merged into one BAM triple + indexes (:1976-2024)

Here the per-library extraction feeds ``align_stream`` directly as padded
batches (no FASTQ round-trip; the ``-C`` RG retention becomes the
ReadBatch.comments ``RG:<id>`` channel), and the double-buffered input
pipeline replaces mbuffer.  The device step runs on the run's device:
cuda unless the caller asks for cpu.

The merged header takes the @RG lines of every input BAM (the first line
of each ID, in first-seen order), as bamcleanheader.py merges all inputs;
so a second BAM's read groups are declared and get libraries of their
own.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from ..formats.bam import BAM_MAGIC, BAMReader
from ..formats.fastq import ReadBatch
from ..formats.sam import FREAD1, FREVERSE, FSECONDARY, FSUPPLEMENTARY
from ..utils.metrics import metrics
from .pipeline import AlignConfig, align_stream


def read_groups_by_library(header_text: str) -> Dict[str, List[str]]:
    """bamlibs.py semantics: group @RG IDs by LB tag (fallback: one group
    per RG; no RGs at all → empty dict, caller synthesizes)."""
    libs: Dict[str, List[str]] = {}
    for line in header_text.splitlines():
        if not line.startswith("@RG"):
            continue
        d = dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
        rid = d.get("ID", "")
        lb = d.get("LB", rid)
        libs.setdefault(lb, []).append(rid)
    return libs


def clean_rg_lines(header_text: str) -> List[str]:
    """bamcleanheader.py: carry the @RG lines through to the new header."""
    return [l for l in header_text.splitlines() if l.startswith("@RG")]


def merged_rg_lines(bam_paths: List[str]) -> List[str]:
    """The @RG lines of every input BAM: the first line of each ID, in
    first-seen order."""
    out, seen = [], set()
    for path in bam_paths:
        with BAMReader(path) as rd:
            for line in clean_rg_lines(rd.header.text):
                rid = dict(f.split(":", 1) for f in line.split("\t")[1:]
                           if ":" in f).get("ID", "")
                if rid not in seen:
                    seen.add(rid)
                    out.append(line)
    return out


# The extract reads each lane BAM a chunk of whole BGZF blocks at a time, so
# its memory is a chunk and the reads still waiting for their mates, whatever
# the size of the BAM.
CHUNK_BYTES = 4 << 20      # compressed bytes a read
INFLATE_THREADS = 4        # of the host's cores: the dispatch and drain
                           # threads of align_stream keep theirs
_SKIP = FSECONDARY | FSUPPLEMENTARY    # records bamtofastq.py leaves out
_TURN = FREVERSE                       # records turned back to the read's
                                       # original orientation


def _inflated(path: str) -> Iterator[bytes]:
    """The BGZF stream of ``path`` inflated a read of ``CHUNK_BYTES`` at a
    time, cut back to whole blocks (the rest goes with the next read).
    Counters ``realign.extract.chunks``, ``.inflated_bytes``."""
    with open(path, "rb") as fh:
        buf = b""
        while True:
            data = fh.read(CHUNK_BYTES)
            buf = buf + data if buf else data
            whole = native.bgzf_whole(buf)
            if whole:
                raw = native.bgzf_decompress(memoryview(buf)[:whole],
                                             INFLATE_THREADS)
                buf = buf[whole:]
                metrics.add("realign.extract.chunks", 1)
                metrics.add("realign.extract.inflated_bytes", len(raw))
                yield raw
            if not data:
                if buf:
                    raise ValueError(f"{path}: truncated BGZF block")
                return


def _header_end(buf: bytes) -> int:
    """Offset of the first record in an inflated BAM stream, or -1 while
    the header runs past ``buf``."""
    if len(buf) >= 4 and buf[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file")
    if len(buf) < 12:
        return -1
    off = 8 + struct.unpack_from("<i", buf, 4)[0]
    if len(buf) < off + 4:
        return -1
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    for _ in range(n_ref):
        if len(buf) < off + 4:
            return -1
        off += 8 + struct.unpack_from("<i", buf, off)[0]
    return off if len(buf) >= off else -1


def _records(path: str) -> Iterator[Tuple[bytes, int, np.ndarray, int]]:
    """The whole records of the BAM at ``path``, a chunk at a time: (the
    inflated bytes, the offset of the records in them, a view of the
    records, the reads among them); a record cut by the chunk's end goes
    with the next chunk."""
    carry, first = b"", -1
    for raw in _inflated(path):
        buf = carry + raw if carry else raw
        if first < 0:
            first = _header_end(buf)
            if first < 0:
                carry = buf
                continue
        recs = np.frombuffer(buf, np.uint8, len(buf) - first, first)
        nbytes, rows = native.bam_whole(recs, _SKIP)
        if nbytes:
            yield buf, first, recs[:nbytes], rows
        carry, first = buf[first + nbytes:], 0
    if carry or first < 0:
        raise ValueError(f"{path}: truncated BAM")


class _Rows(NamedTuple):
    """Reads in their original orientation, a row each: padded codes and
    qualities, lengths, read groups (indices into the extract's table)."""
    seq: np.ndarray
    qual: np.ndarray
    length: np.ndarray
    rg: np.ndarray

    def take(self, i) -> "_Rows":
        return _Rows(*(c[i] for c in self))


class _Store:
    """The extract's rows by id: the current chunk's (ids ``base`` on) and
    those of earlier chunks still wanted (``old_ids``, ascending)."""

    def __init__(self, max_len: int):
        z = np.zeros((0, max_len), np.uint8)
        self.old = _Rows(z, z, np.zeros(0, np.int32), np.zeros(0, np.int32))
        self.old_ids = np.zeros(0, np.int64)
        self.cur, self.base = self.old, 0

    def add(self, rows: _Rows) -> int:
        """Make ``rows`` the current chunk; returns the id of its first."""
        self.base += len(self.cur.length)
        self.cur = rows
        return self.base

    def take(self, ids: np.ndarray) -> _Rows:
        fresh = ids >= self.base
        if fresh.all():
            return self.cur.take(ids - self.base)
        old = self.old.take(np.searchsorted(self.old_ids, ids[~fresh]))
        if not fresh.any():
            return old
        new = self.cur.take(ids[fresh] - self.base)
        pos = np.empty(len(ids), np.int64)
        pos[~fresh] = np.arange(len(old.length))
        pos[fresh] = len(old.length) + np.arange(len(new.length))
        return _Rows(*(np.concatenate([a, b])[pos] for a, b in zip(old, new)))

    def keep(self, ids: np.ndarray) -> None:
        """Keep only the rows ``ids`` (ascending) for later chunks."""
        self.old = self.take(ids)
        self.old_ids = ids


def _rg_index(src: np.ndarray, rg_off: np.ndarray, rg_len: np.ndarray,
              table: Dict[bytes, int]) -> np.ndarray:
    """Each row's read group, the RG value at (``rg_off``, ``rg_len``) in
    ``src`` (length 0 without one: b""), as its index in ``table``; values
    new to the table are added in the order np.unique gives.  Only the
    first row of each run of equal values is looked up: a lane's records
    mostly share one."""
    n, w = len(rg_off), int(rg_len.max(initial=0))
    if w == 0:
        return np.full(n, table.setdefault(b"", len(table)), np.int32)
    j = np.arange(w)
    inside = j < rg_len[:, None]
    at = np.where(inside, np.maximum(rg_off, 0)[:, None] + j, 0)
    mat = np.where(inside, src[at], 0).astype(np.uint8)
    runs = np.flatnonzero(np.r_[True, (mat[1:] != mat[:-1]).any(axis=1)])
    uniq, inv = np.unique(mat[runs], axis=0, return_inverse=True)
    ids = np.array([table.setdefault(u.tobytes().rstrip(b"\0"), len(table))
                    for u in uniq], np.int32)
    return np.repeat(ids[inv.reshape(-1)], np.diff(np.r_[runs, n]))


def iter_bam_pairs(
    bam_paths: List[str],
    rg_ids: Optional[set],
    batch_size: int,
    max_len: int,
    rename: bool = False,
) -> Iterator[Tuple[ReadBatch, Optional[ReadBatch]]]:
    """Pair up primary records by qname across coordinate-sorted BAMs
    (bamtofastq.py + bamfilterrg.py roles), yielding padded batches in
    input order: the BAMs in turn, each pair where its later mate lies.

    A chunk at a time (``_records``), under three spans:
    ``realign.extract.decode`` (the chunk's read, its parallel inflate and
    the scan for its whole records, in C), ``realign.extract.pack`` (the
    records' reads in their original orientation as padded rows in one C
    pass, the read-group filter as column operations, and each batch a
    gather of rows) and ``realign.extract.pair`` (the mate dict, name to
    row, and the batch list).  Counters: ``realign.records`` (primary
    records taken), ``realign.pairs``, ``realign.orphans`` (reads whose
    mate never came), ``realign.pending_peak`` (the most reads held
    waiting for their mates), and ``realign.extract.chunks`` and
    ``.inflated_bytes``."""
    store = _Store(max_len)
    rg_table: Dict[bytes, int] = {}
    comment: List[str] = []
    pending: Dict[bytes, int] = {}
    peak = 0
    r1: List[int] = []           # the ready pairs' rows, in input order
    r2: List[int] = []
    names: List[bytes] = []
    n_emitted = 0

    def pack(i1, i2, keys) -> Tuple[ReadBatch, Optional[ReadBatch]]:
        nonlocal n_emitted
        nm = ([f"r{k}" for k in range(n_emitted, n_emitted + len(keys))]
              if rename else [k.decode() for k in keys])
        n_emitted += len(keys)
        out = []
        for ids in (i1, i2):
            if ids is None:
                out.append(None)
                continue
            rows = store.take(np.asarray(ids, np.int64))
            out.append(ReadBatch(rows.seq, rows.qual, rows.length, list(nm),
                                 [comment[g] for g in rows.rg.tolist()]))
        return out[0], out[1]

    for path in bam_paths:
        chunks = _records(path)
        while True:
            with metrics.timer("realign.extract.decode"):
                got = next(chunks, None)
            if got is None:
                break
            buf, at, recs, n_rows = got
            with metrics.timer("realign.extract.pack"):
                rd = native.bam_reads(recs, n_rows, _SKIP, _TURN, max_len)
                rg = _rg_index(recs, rd.rg_off, rd.rg_len, rg_table)
                comment += [f"RG:{k.decode()}"
                            for k in list(rg_table)[len(comment):]]
                keep = slice(None) if rg_ids is None else np.array(
                    [k.decode() in rg_ids for k in rg_table], bool)[rg]
                base = store.add(_Rows(rd.seq, rd.qual, rd.length,
                                       rg).take(keep))
                qname = rd.qname_off[keep] + at
                qend = qname + rd.qname_len[keep]
                read1 = (rd.flag[keep] & FREAD1) != 0
            with metrics.timer("realign.extract.pair"):
                n = len(read1)
                metrics.add("realign.records", n)
                pop = pending.pop
                for rid, a, b, first in zip(
                        range(base, base + n), qname.tolist(),
                        qend.tolist(), read1.tolist()):
                    key = buf[a:b]
                    mate = pop(key, None)
                    if mate is None:
                        pending[key] = rid
                        if len(pending) > peak:
                            peak = len(pending)
                        continue
                    r1.append(rid if first else mate)
                    r2.append(mate if first else rid)
                    names.append(key)
                n_full = len(names) // batch_size * batch_size
            with metrics.timer("realign.extract.pack"):
                out = [pack(r1[i:i + batch_size], r2[i:i + batch_size],
                            names[i:i + batch_size])
                       for i in range(0, n_full, batch_size)]
                del r1[:n_full], r2[:n_full], names[:n_full]
                store.keep(np.sort(np.concatenate([
                    np.fromiter(pending.values(), np.int64, len(pending)),
                    np.asarray(r1 + r2, np.int64)])))
            metrics.add("realign.pairs", n_full)
            yield from out
    if names:
        with metrics.timer("realign.extract.pack"):
            last = pack(r1, r2, names)
        metrics.add("realign.pairs", len(names))
        yield last
    metrics.add("realign.pending_peak", peak)
    metrics.add("realign.orphans", len(pending))
    # orphans: reads whose mate never appeared (truncated BAM, single-end
    # read groups, mate filtered upstream) are realigned single-end rather
    # than silently dropped
    orphans = list(pending.items())
    pending.clear()
    for i in range(0, len(orphans), batch_size):
        chunk = orphans[i:i + batch_size]
        with metrics.timer("realign.extract.pack"):
            b, _ = pack([rid for _, rid in chunk], None,
                        [key for key, _ in chunk])
        yield b, None


def realign(
    reference: str,
    bam_paths: List[str],
    out_prefix: str,
    config: AlignConfig = AlignConfig(),
    rename: bool = False,
    device=None,
) -> Dict[str, str]:
    """Run the realign module on ``device`` (cuda unless the caller asks
    for cpu); returns output paths.  Span ``realign.extract``: the BAM
    decode and batch building, summed over the input (its parts in
    ``iter_bam_pairs``); counter ``realign.libraries``: the groups of
    ``read_groups_by_library``, each its own duplicate scope."""
    cfg = config
    rg_lines = merged_rg_lines(bam_paths)
    if cfg.rg_string:  # -R override (supersedes input BAM readgroups)
        rg_lines = [cfg.rg_string.replace("\\t", "\t")]
    if not rg_lines:
        # RG synthesis fallback (bin/speedseq:1899-1911)
        rg_lines = [f"@RG\tID:{cfg.rg_id}\tSM:{cfg.sample}"]
    metrics.add("realign.libraries",
                len(read_groups_by_library("\n".join(rg_lines))))

    # the reference processes libraries separately only to bound dup-
    # marking scope (bin/speedseq:1930-1973); the dup signatures here are
    # keyed by library (pipeline._lib_map over these @RG lines) and all
    # libraries share the aligner, so one stream suffices: each read's
    # group flows through the RG: comments
    batches = metrics.timed(iter_bam_pairs(
        bam_paths, None, cfg.batch_size, cfg.max_read_len, rename=rename
    ), "realign.extract")
    return align_stream(
        reference, batches, out_prefix, cfg, rg_lines=rg_lines, paired=True,
        device=device,
    )
