"""Structural-variant calling (LUMPY + SVTyper + CNVnator equivalents).

Reference contract (bin/speedseq:1205-1641):
- ``lumpyexpress -B full -S splitters -D discordants [-x exclude.bed] -P
  -r 0 -m 4`` (:1473-1485): paired-end + split-read evidence →
  probabilistic breakpoint clusters → VCF (DEL/DUP/INV/BND) with
  SU/PE/SR, IMPRECISE/CIPOS/CIEND, PRPOS/PREND curves (-P).
- ``svtyper -q -i sv.vcf -B full.bam -S splitters.bam`` per sample
  (:1488-1505): Bayesian breakend genotyping → GT/GQ/SQ/GL columns.
- ``cnvnator_wrapper.py`` + ``annotate_rd.py`` (:1509-1551): 100 bp
  read-depth bins → GC-correct → partition → CNV calls + per-SV CN
  FORMAT annotation.

``columnar`` (BAM column scans) is shared with ``formats/bai.py``.
"""

from .engine import SVConfig, SVSample, run_sv  # noqa: F401
