"""Columnar BAM scanning for the SV engine.

The reference's SV stack is per-record C/Python stream processing
(lumpyexpress's bamfilterrg/pairend_distro pipes, svtyper's pysam fetch
loops — contracts at bin/speedseq:1473-1505).  Round 2
reproduced those as per-record Python; this module is the columnar
replacement: whole files (or BAI regions) decode to struct-of-arrays in
one native call (csrc ssq_bam_decode), and every classification — flag
masks, cigar clip/ref-length, MC/SA tag extraction, orientation logic —
is a numpy column op.  Python objects exist only for actual evidence
items (a few % of records) and final VCF records.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..formats.sam import (
    FDUP, FMREVERSE, FMUNMAP, FPAIRED, FPROPER_PAIR, FREAD1, FREVERSE,
    FSECONDARY, FSUPPLEMENTARY, FUNMAP,
)

_CIG_RCONSUME = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0], bool)  # M D N = X


def read_bam_columns(path: str, with_blob: bool = False):
    """Whole-file columnar read: one parallel BGZF inflate + one native
    record decode.  Returns (refs [(name, len)], BamColumns) — plus the
    raw block_size-prefixed record bytes when ``with_blob`` (for
    subset-and-rewrite flows via native.gather_records)."""
    with open(path, "rb") as fh:
        raw = native.bgzf_decompress(fh.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM")
    (l_text,) = struct.unpack_from("<i", raw, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        name = raw[off + 4 : off + 4 + l_name - 1].decode()
        (l_ref,) = struct.unpack_from("<i", raw, off + 4 + l_name)
        refs.append((name, l_ref))
        off += 8 + l_name
    cols = native.bam_decode(raw[off:])
    if with_blob:
        return refs, cols, np.frombuffer(raw, np.uint8, len(raw) - off, off)
    return refs, cols


def record_sizes(cols) -> np.ndarray:
    """(n,) on-disk record size incl. the 4-byte block_size prefix,
    reconstructed from the decoded columns (bam1_t layout)."""
    lq = np.diff(cols.qname_off)
    nc = np.diff(cols.cigar_off)
    ls = np.diff(cols.seq_off)
    la = np.diff(cols.aux_off)
    return (4 + 32 + (lq + 1) + 4 * nc + (ls + 1) // 2 + ls + la).astype(
        np.int64)


def cigar_ref_lengths(cols) -> np.ndarray:
    """(n,) reference-consumed length per record (0 for empty cigars)."""
    ops = (cols.cigar_blob & 0xF).astype(np.int64)
    lens = (cols.cigar_blob >> 4).astype(np.int64)
    rc = np.where(_CIG_RCONSUME[np.minimum(ops, 9)], lens, 0)
    c = np.concatenate([[0], np.cumsum(rc)])
    return c[cols.cigar_off[1:]] - c[cols.cigar_off[:-1]]


def clip_flags(cols) -> Tuple[np.ndarray, np.ndarray]:
    """(clip_left, clip_right) bool per record: first/last cigar op is
    S or H (empty cigars → False)."""
    n = cols.n
    ncig = np.diff(cols.cigar_off)
    has = ncig > 0
    first = np.zeros(n, np.int64)
    last = np.zeros(n, np.int64)
    f_idx = np.where(has, cols.cigar_off[:-1], 0)
    l_idx = np.where(has, cols.cigar_off[1:] - 1, 0)
    if len(cols.cigar_blob):
        first = (cols.cigar_blob[f_idx] & 0xF).astype(np.int64)
        last = (cols.cigar_blob[l_idx] & 0xF).astype(np.int64)
    cl = has & ((first == 4) | (first == 5))
    cr = has & ((last == 4) | (last == 5))
    return cl, cr


def ztag_strings(cols, tag: str):
    """(offsets, lengths) of a Z tag's value in cols.aux_blob; -1 absent."""
    return native.find_ztag(
        np.ascontiguousarray(cols.aux_blob, np.uint8),
        np.ascontiguousarray(cols.aux_off, np.int64), tag)


def unique_ztag_values(cols, tag: str):
    """Vectorized distinct-Z-tag lookup: (rows, uniques, inverse) where
    ``rows`` are the record indices carrying the tag, ``uniques`` the
    distinct decoded strings, and ``uniques[inverse[i]]`` the value of
    record ``rows[i]``.  Per distinct tag length the bytes gather into a
    matrix and np.unique over rows finds the handful of distinct values
    — no per-record Python walk (shared by bamfilterrg and the var
    multi-sample RG mapping)."""
    off, ln = ztag_strings(cols, tag)
    aux = cols.aux_blob
    have = np.nonzero(off >= 0)[0]
    out_rows, out_inv, uniqs = [], [], []
    for L in (np.unique(ln[have]) if len(have) else []):
        rows = have[ln[have] == L]
        if L == 0:
            out_rows.append(rows)
            out_inv.append(np.full(len(rows), len(uniqs), np.int64))
            uniqs.append("")
            continue
        mat = aux[off[rows][:, None] + np.arange(L)[None, :]]
        u, inv = np.unique(mat, axis=0, return_inverse=True)
        out_rows.append(rows)
        out_inv.append(np.asarray(inv, np.int64) + len(uniqs))
        uniqs.extend(x.tobytes().decode() for x in u)
    if out_rows:
        return np.concatenate(out_rows), uniqs, np.concatenate(out_inv)
    return np.zeros(0, np.int64), [], np.zeros(0, np.int64)


def mate_ref_lengths(cols, default: int) -> np.ndarray:
    """(n,) mate reference span from the MC tag; ``default`` where the
    tag is absent (the reference uses read_len there too)."""
    off, ln = ztag_strings(cols, "MC")
    out = native.cigar_str_reflen(
        np.ascontiguousarray(cols.aux_blob, np.uint8), off, ln)
    return np.where(off >= 0, out, default).astype(np.int64)


def end_positions(cols) -> np.ndarray:
    rl = cigar_ref_lengths(cols)
    return cols.pos.astype(np.int64) + np.maximum(rl, 1)
