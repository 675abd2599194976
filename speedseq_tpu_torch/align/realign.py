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

import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..formats.bam import BAMReader
from ..formats.fastq import ReadBatch
from ..formats.fasta import encode_bases
from ..formats.sam import FREAD1, FREVERSE, FSECONDARY, FSUPPLEMENTARY, SAMRecord
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


def _record_to_read(rec: SAMRecord) -> Tuple[np.ndarray, np.ndarray]:
    """Original-orientation (seq codes, quals) — bamtofastq.py behavior:
    reverse-strand alignments are reverse-complemented back."""
    seq = encode_bases(rec.seq.encode())
    if rec.qual == "*":
        qual = np.full(len(seq), 30, np.uint8)
    else:
        qual = np.frombuffer(rec.qual.encode(), np.uint8) - 33
    if rec.flag & FREVERSE:
        seq = np.where(seq[::-1] < 4, 3 - seq[::-1], 4).astype(np.uint8)
        qual = qual[::-1].copy()
    return seq, qual


def _pack(recs: List[SAMRecord], names: List[str],
          max_len: int) -> ReadBatch:
    """One padded batch of ``recs`` in their original orientation, each
    read's group carried as an ``RG:<id>`` comment."""
    n = len(recs)
    seq = np.full((n, max_len), 4, np.uint8)
    qual = np.zeros((n, max_len), np.uint8)
    length = np.zeros(n, np.int32)
    comments = []
    for i, rec in enumerate(recs):
        s, q = _record_to_read(rec)
        L = min(len(s), max_len)
        seq[i, :L] = s[:L]
        qual[i, :L] = q[:L]
        length[i] = L
        comments.append(f"RG:{rec.get_tag('RG') or ''}")
    return ReadBatch(seq, qual, length, list(names), comments)


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

    The work runs a batch's stretch at a time under three spans:
    ``realign.extract.decode`` (BGZF inflate and record parse),
    ``realign.extract.pair`` (the mate dict and the batch list) and
    ``realign.extract.pack`` (original orientation and padded arrays).
    Counters: ``realign.records`` (primary records taken),
    ``realign.pairs``, ``realign.orphans`` (reads whose mate never
    came) and ``realign.pending_peak`` (the most reads held waiting for
    their mates)."""
    pending: Dict[str, SAMRecord] = {}
    peak = 0
    ready: List[Tuple[str, SAMRecord, SAMRecord]] = []
    n_emitted = 0

    def name(qname: str) -> str:
        nonlocal n_emitted
        n_emitted += 1
        return f"r{n_emitted - 1}" if rename else qname

    def pack(items) -> Tuple[ReadBatch, ReadBatch]:
        names = [name(q) for q, _, _ in items]
        return (_pack([r1 for _, r1, _ in items], names, max_len),
                _pack([r2 for _, _, r2 in items], names, max_len))

    for path in bam_paths:
        with BAMReader(path) as rd:
            it = iter(rd)
            while True:
                with metrics.timer("realign.extract.decode"):
                    recs = list(itertools.islice(it, 2 * batch_size))
                if not recs:
                    break
                with metrics.timer("realign.extract.pair"):
                    taken = 0
                    for rec in recs:
                        if rec.flag & (FSECONDARY | FSUPPLEMENTARY):
                            continue
                        if rec.seq in ("*", ""):
                            continue
                        if rg_ids is not None and (
                                rec.get_tag("RG") or "") not in rg_ids:
                            continue
                        taken += 1
                        mate = pending.pop(rec.qname, None)
                        if mate is None:
                            pending[rec.qname] = rec
                            peak = max(peak, len(pending))
                            continue
                        r1, r2 = ((rec, mate) if rec.flag & FREAD1
                                  else (mate, rec))
                        ready.append((rec.qname, r1, r2))
                    metrics.add("realign.records", taken)
                    n_full = len(ready) // batch_size * batch_size
                    full, ready = ready[:n_full], ready[n_full:]
                if not full:
                    continue
                with metrics.timer("realign.extract.pack"):
                    out = [pack(full[i:i + batch_size])
                           for i in range(0, n_full, batch_size)]
                metrics.add("realign.pairs", n_full)
                yield from out
    if ready:
        with metrics.timer("realign.extract.pack"):
            last = pack(ready)
        metrics.add("realign.pairs", len(ready))
        yield last
    metrics.add("realign.pending_peak", peak)
    metrics.add("realign.orphans", len(pending))
    # orphans: reads whose mate never appeared (truncated BAM, single-end
    # read groups, mate filtered upstream) are realigned single-end rather
    # than silently dropped
    orphans = list(pending.values())
    pending.clear()
    for i in range(0, len(orphans), batch_size):
        chunk = orphans[i:i + batch_size]
        with metrics.timer("realign.extract.pack"):
            b = _pack(chunk, [name(r.qname) for r in chunk], max_len)
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
