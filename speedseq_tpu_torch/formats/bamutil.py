"""bamkit-equivalent BAM utilities.

The reference vendors five small pysam scripts (.gitmodules:19-21,
bin/speedseq:1885-1962): bamtofastq / bamheadrg / bamlibs /
bamcleanheader live inside align.realign; this module provides the two
standalone ones — bamfilterrg (subset by read group) and bamgroupreads
(name-grouped output) — columnarly where it counts.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from .bam import BAMReader, BAMWriter
from .sam import FREAD1, FREAD2


def filter_read_groups(
    in_bam: str, out_bam: str, rg_ids: Sequence[str]
) -> int:
    """bamfilterrg.py equivalent: keep records whose RG tag is in
    ``rg_ids`` (records with no RG are kept only if '' is listed).
    Header @RG lines are narrowed to the kept ids.  Returns kept count.

    Columnar: whole-file native decode, RG spans via the aux Z-tag
    scanner, one gather rewrite."""
    from .. import native

    keep_set = set(rg_ids)
    with BAMReader(in_bam) as rd:
        header = rd.header
    lines = [
        ln for ln in header.text.splitlines()
        if not ln.startswith("@RG")
        or (m := re.search(r"\tID:([^\t]+)", ln)) and m.group(1) in keep_set
    ]
    from .sam import SAMHeader

    new_header = SAMHeader(text="\n".join(lines) + "\n", refs=header.refs)

    from ..sv.columnar import (
        read_bam_columns, record_sizes, unique_ztag_values,
    )

    refs, cols, blob = read_bam_columns(in_bam, with_blob=True)
    keep = np.full(cols.n, "" in keep_set, bool)  # tag-less records
    rows, uniqs, inv = unique_ztag_values(cols, "RG")
    if len(rows):
        ok = np.array([u in keep_set for u in uniqs], bool)
        keep[rows] = ok[inv]
    sizes = record_sizes(cols)
    starts = np.zeros(cols.n, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    sel = np.nonzero(keep)[0]
    with BAMWriter(out_bam, new_header) as w:
        w.write_blob(native.gather_records(
            blob, starts, sizes, sel).tobytes())
    return len(sel)


_NAT = re.compile(r"(\d+)")


def _natural_key(name: str):
    """samtools name-sort comparator: digit runs compare numerically
    (bam_sort.c:1609 strnum_cmp semantics)."""
    return tuple(
        int(p) if p.isdigit() else p for p in _NAT.split(name)
    )


def group_reads_by_name(in_bam: str, out_bam: str) -> int:
    """bamgroupreads.py equivalent: rewrite with records grouped by
    query name (natural-number name order, read1 before read2 —
    bam_sort.c:1609-1610), the input shape samblaster expects."""
    with BAMReader(in_bam) as rd:
        header = rd.header
        recs = list(rd)
    recs.sort(key=lambda r: (
        _natural_key(r.qname),
        0 if r.flag & FREAD1 else (1 if r.flag & FREAD2 else 2),
        1 if r.flag & 0x900 else 0,
    ))
    from .sam import SAMHeader

    hdr = SAMHeader(
        text=re.sub(r"SO:\S+", "SO:queryname", header.text, count=1)
        if "SO:" in header.text else header.text,
        refs=header.refs,
    )
    with BAMWriter(out_bam, hdr) as w:
        w.write_batch(recs)
    return len(recs)
