"""BED interval IO + window utilities.

The reference uses BED files for (a) variant-calling parallelization
windows (bin/speedseq:677-719; annotations/ceph18.b37.include.2014-01-15.bed
— 34,123 depth-balanced windows sorted most-expensive-first, README.md:153-
155) and (b) SV exclusion regions (lumpy -x, bin/speedseq:1287-1289).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np


@dataclass
class BedInterval:
    chrom: str
    start: int
    end: int
    name: str = ""


def read_bed(path: str) -> List[BedInterval]:
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith(("#", "track", "browser")) or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            out.append(
                BedInterval(f[0], int(f[1]), int(f[2]), f[3] if len(f) > 3 else "")
            )
    return out


def write_bed(path: str, intervals: Iterable[BedInterval]) -> None:
    with open(path, "w") as fh:
        for iv in intervals:
            extra = f"\t{iv.name}" if iv.name else ""
            fh.write(f"{iv.chrom}\t{iv.start}\t{iv.end}{extra}\n")


def windows_from_refs(
    refs: List[Tuple[str, int]], window: int = 0
) -> List[BedInterval]:
    """Per-chromosome windows from @SQ refs (bin/speedseq:677-687 fallback:
    one window per chromosome when no -w BED is given); optional fixed-size
    chunking."""
    out = []
    for name, length in refs:
        if window <= 0 or window >= length:
            out.append(BedInterval(name, 0, length))
        else:
            for s in range(0, length, window):
                out.append(BedInterval(name, s, min(s + window, length)))
    return out


def longest_first(intervals: List[BedInterval]) -> List[BedInterval]:
    """Greedy most-expensive-first schedule: reproduces the reference's
    depth-balanced window ordering trick (README.md:153-155)."""
    return sorted(intervals, key=lambda iv: iv.end - iv.start, reverse=True)


class ExcludeMask:
    """Fast per-chromosome exclusion lookup (lumpy -x semantics)."""

    def __init__(self, intervals: List[BedInterval]):
        self._by_chrom: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        tmp: Dict[str, List[Tuple[int, int]]] = {}
        for iv in intervals:
            tmp.setdefault(iv.chrom, []).append((iv.start, iv.end))
        for chrom, ivs in tmp.items():
            ivs.sort()
            merged = []
            for s, e in ivs:
                if merged and s <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((s, e))
            arr = np.array(merged, dtype=np.int64)
            self._by_chrom[chrom] = (arr[:, 0], arr[:, 1])

    def contains(self, chrom: str, pos) -> np.ndarray:
        """Vectorized: True where pos falls in an excluded interval."""
        pos = np.asarray(pos, dtype=np.int64)
        if chrom not in self._by_chrom:
            return np.zeros(pos.shape, dtype=bool)
        starts, ends = self._by_chrom[chrom]
        idx = np.searchsorted(starts, pos, side="right") - 1
        valid = idx >= 0
        idx = np.maximum(idx, 0)
        return valid & (pos < ends[idx])

    def overlaps(self, chrom: str, start: int, end: int) -> bool:
        if chrom not in self._by_chrom:
            return False
        starts, ends = self._by_chrom[chrom]
        i = np.searchsorted(ends, start, side="right")
        return i < len(starts) and starts[i] < end
