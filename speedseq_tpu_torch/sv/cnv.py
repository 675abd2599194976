"""Read-depth CNV analysis (CNVnator-equivalent).

Reference contract (bin/cnvnator_wrapper.py:75-235, bin/annotate_rd.py):
``-tree`` (read placement) → ``-his`` (100 bp bin counts per chrom) →
``-stat`` → ``-partition`` (mean-shift) → ``-call``; plus ``-genotype``
returning normalized copy number for arbitrary intervals (annotate_rd.py:
294-296 uses it to add a CN FORMAT field to the SV VCF).

[external knowledge: Abyzov et al. 2011 for the algorithm].  On the run's
device (sv/device.py): read binning as one global bincount, GC-stratum
correction as stratum reductions, and an iterative mean-shift partitioner
with depth-dependent signal bandwidth.  ROOT files are replaced by arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..device import resolve_device
from ..formats.fasta import FastaFile
from ..formats.sam import FDUP, FSECONDARY, FSUPPLEMENTARY, FUNMAP


@dataclass
class CNVCall:
    chrom: str
    start: int
    end: int
    kind: str          # "deletion" | "duplication"
    norm_rd: float     # normalized read depth (1.0 = diploid)


@dataclass
class DepthProfile:
    bin_size: int
    chroms: List[str]
    counts: Dict[str, np.ndarray]       # raw per-bin read counts
    corrected: Dict[str, np.ndarray]    # GC-corrected
    mean: float                         # global per-bin mean (autosome)
    device: object = None               # where partition() runs (cuda
    #                                     unless the caller asks for cpu)

    @classmethod
    def from_bam(
        cls, bam_path: str, fasta_path: str, bin_size: int = 100,
        device=None,
    ) -> "DepthProfile":
        """-tree/-his equivalents: bin read placements (midpoints), then
        GC-correct; both on the run's device."""
        from . import device as dev_mod
        from .columnar import end_positions, read_bam_columns

        device = resolve_device(device)
        fa = FastaFile(fasta_path)
        refs, cols = read_bam_columns(bam_path)
        names = [n for n, _ in refs]
        nb_per = np.array([(l + bin_size - 1) // bin_size for _, l in refs],
                          np.int64)
        flags = cols.flag.astype(np.int64)
        keep = (
            ((flags & (FUNMAP | FSECONDARY | FSUPPLEMENTARY | FDUP)) == 0)
            & (cols.tid >= 0)
        )
        tid = cols.tid[keep].astype(np.int64)
        mid = (cols.pos[keep].astype(np.int64)
               + end_positions(cols)[keep]) // 2
        b = mid // bin_size
        # one global bincount (-his equivalent); out-of-contig bins go to a
        # dump bin past the end
        offs = np.concatenate([[0], np.cumsum(nb_per)])
        total = int(offs[-1])
        ok = (b >= 0) & (b < nb_per[tid])
        flat = dev_mod.depth_bins(np.where(ok, offs[tid] + b, total),
                                  total + 1, device=device)[:total]
        counts = {n: flat[offs[i]:offs[i + 1]].astype(np.float64)
                  for i, n in enumerate(names)}
        # GC per bin + stratified correction (cnvnator gc correction)
        gc_of: Dict[str, np.ndarray] = {}
        for n, l in refs:
            seq = fa.fetch_encoded(n)
            nb = (l + bin_size - 1) // bin_size
            pad = np.full(nb * bin_size, 4, np.uint8)
            pad[:l] = seq
            m = pad.reshape(nb, bin_size)
            valid = (m < 4).sum(axis=1)
            gcc = ((m == 1) | (m == 2)).sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                gc_of[n] = np.where(valid > 0, gcc / np.maximum(valid, 1), -1.0)
        fa.close()
        allc = np.concatenate([counts[n] for n in names])
        allgc = np.concatenate([gc_of[n] for n in names])
        used = allgc >= 0
        strata = np.clip((allgc * 100).astype(int), 0, 100)
        corrected: Dict[str, np.ndarray] = {}
        mean = 0.0
        if len(allc):
            # -stat + GC correction in one program
            corr_flat, mean = dev_mod.gc_correct(allc, strata, used,
                                                 device=device)
            corr_flat = corr_flat.astype(np.float64)
            for i, n in enumerate(names):
                corrected[n] = corr_flat[offs[i]:offs[i + 1]]
        return cls(
            bin_size=bin_size, chroms=names, counts=counts,
            corrected=corrected, mean=max(mean, 1e-9), device=device,
        )

    # ---- partition (-partition equivalent) ------------------------------
    def partition(self, chrom: str) -> np.ndarray:
        """Mean-shift partition (CNVnator -partition,
        bin/cnvnator_wrapper.py:128-135) on the device: abrupt CNV
        boundaries stay sharp because the signal kernel decouples
        dissimilar depths."""
        from . import device as dev_mod

        x = self.corrected[chrom].copy()
        if len(x) == 0:
            return x
        return dev_mod.mean_shift_partition(x, self.mean, device=self.device)

    # ---- call (-call equivalent) ----------------------------------------
    def call(
        self, chrom: str, del_thresh: float = 0.75, dup_thresh: float = 1.25,
        min_bins: int = 3,
    ) -> List[CNVCall]:
        part = self.partition(chrom)
        norm = part / self.mean
        state = np.where(norm < del_thresh, -1, np.where(norm > dup_thresh, 1, 0))
        calls: List[CNVCall] = []
        i = 0
        n = len(state)
        while i < n:
            if state[i] == 0:
                i += 1
                continue
            j = i
            while j < n and state[j] == state[i]:
                j += 1
            if j - i >= min_bins:
                calls.append(
                    CNVCall(
                        chrom=chrom,
                        start=i * self.bin_size,
                        end=j * self.bin_size,
                        kind="deletion" if state[i] < 0 else "duplication",
                        norm_rd=float(norm[i:j].mean()),
                    )
                )
            i = j
        return calls

    def call_all(self) -> List[CNVCall]:
        out = []
        for c in self.chroms:
            out.extend(self.call(c))
        return out

    # ---- genotype (-genotype equivalent; annotate_rd.py:294-296) --------
    def genotype(self, chrom: str, start: int, end: int) -> float:
        """Copy number of [start, end): normalized depth × 2."""
        b0 = start // self.bin_size
        b1 = max(b0 + 1, (end + self.bin_size - 1) // self.bin_size)
        arr = self.corrected.get(chrom)
        if arr is None or len(arr) == 0:
            return 2.0
        seg = arr[b0 : min(b1, len(arr))]
        if len(seg) == 0:
            return 2.0
        return round(float(seg.mean() / self.mean * 2.0), 2)

    def write_calls_txt(self, path: str, calls: List[CNVCall]) -> None:
        """readdepth.txt output shape (cnvnator -call text columns)."""
        with open(path, "w") as fh:
            for c in calls:
                size = c.end - c.start
                fh.write(
                    f"{c.kind}\t{c.chrom}:{c.start + 1}-{c.end}\t{size}\t"
                    f"{c.norm_rd:.6g}\t0\t0\t0\t0\n"
                )

    def write_calls_bed(self, path: str, calls: List[CNVCall]) -> None:
        """readdepth.bed output (cnvnator_wrapper.py bed conversion)."""
        with open(path, "w") as fh:
            for c in calls:
                fh.write(
                    f"{c.chrom}\t{c.start}\t{c.end}\t{c.kind}\t{c.norm_rd:.4g}\n"
                )
