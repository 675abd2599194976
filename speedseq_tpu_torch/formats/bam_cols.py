"""Columnar BAM batch codec bridging SAMRecord lists ↔ native arrays.

The hot emission path of the align pipeline encodes thousands of records per
batch; the native runtime (csrc/ssq_native.cc ssq_bam_encode/ssq_bam_decode,
bam_write1/bam_read1 equivalents per htslib sam.c:407,443) does that in one
C call over struct-of-arrays.  This module builds those arrays; the
output is byte-identical to looping ``encode_record``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from .bam import _encode_aux
from .sam import SAMRecord, cigar_ref_len


def records_to_columns(records: List[SAMRecord]):
    """Build BamColumns from SAMRecord objects (native encode input)."""
    n = len(records)
    tid = np.empty(n, np.int32)
    pos = np.empty(n, np.int32)
    ref_end = np.empty(n, np.int32)
    mapq = np.empty(n, np.uint8)
    flag = np.empty(n, np.uint16)
    mtid = np.empty(n, np.int32)
    mpos = np.empty(n, np.int32)
    tlen = np.empty(n, np.int32)
    qname_off = np.zeros(n + 1, np.int64)
    cigar_off = np.zeros(n + 1, np.int64)
    seq_off = np.zeros(n + 1, np.int64)
    aux_off = np.zeros(n + 1, np.int64)
    qnames: List[bytes] = []
    cigars: List[np.ndarray] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    auxs: List[bytes] = []
    for i, r in enumerate(records):
        tid[i], pos[i], mapq[i], flag[i] = r.tid, r.pos, r.mapq, r.flag
        mtid[i], mpos[i], tlen[i] = r.mtid, r.mpos, r.tlen
        if r.tid >= 0 and r.pos >= 0:
            rl = cigar_ref_len(r.cigar)
            ref_end[i] = r.pos + (rl if rl else 1)
        else:
            # match encode_record's reg2bin(-1, 0) for unplaced records
            pos_bin = -1 if r.pos < 0 else r.pos
            ref_end[i] = pos_bin + 1 if pos_bin >= 0 else 0
        qb = r.qname.encode()
        qnames.append(qb)
        qname_off[i + 1] = qname_off[i] + len(qb)
        cg = np.asarray([(ln << 4) | op for op, ln in r.cigar], np.uint32)
        cigars.append(cg)
        cigar_off[i + 1] = cigar_off[i] + len(cg)
        seq = b"" if r.seq in ("*", "") else r.seq.encode()
        if r.qual in ("*", "") or not seq:
            qual = b"\xff" * len(seq)
        else:
            qual = (
                np.frombuffer(r.qual.encode("latin-1"), np.uint8) - 33
            ).tobytes()
        seqs.append(seq)
        quals.append(qual)
        seq_off[i + 1] = seq_off[i] + len(seq)
        ab = _encode_aux(r.tags)
        auxs.append(ab)
        aux_off[i + 1] = aux_off[i] + len(ab)
    def _blob(parts, dtype=np.uint8):
        joined = b"".join(parts)
        return np.frombuffer(joined, np.uint8).copy() if joined else np.zeros(1, np.uint8)
    cig_cat = (np.concatenate(cigars) if any(len(c) for c in cigars)
               else np.zeros(1, np.uint32)).astype(np.uint32)
    return native.BamColumns(
        tid=tid, pos=pos, ref_end=ref_end, mapq=mapq, flag=flag, mtid=mtid,
        mpos=mpos, tlen=tlen, qname_blob=_blob(qnames), qname_off=qname_off,
        cigar_blob=cig_cat, cigar_off=cigar_off, seq_blob=_blob(seqs),
        qual_blob=_blob(quals), seq_off=seq_off, aux_blob=_blob(auxs),
        aux_off=aux_off)


def encode_batch(records: List[SAMRecord]) -> bytes:
    """Concatenated block_size-prefixed records, byte-equal to looping
    struct.pack(len)+encode_record."""
    if not records:
        return b""
    return native.bam_encode(records_to_columns(records))
