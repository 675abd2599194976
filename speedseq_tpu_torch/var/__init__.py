"""SNV/indel calling over genomic windows (FreeBayes-equivalent), the
port's counterpart of speedseq_tpu.var.

Reference contract (bin/speedseq:506-833):
``freebayes -f ref --region chr:start..end --min-repeat-entropy 1`` per
window, piped through ``vawk '$6>=QUAL && I$RPR>0 && I$RPL>0'``, windows
merged by coordinate sort, bgzip + tabix.

Pipeline here: pileup (host, vectorized numpy) → candidate alleles, with
haplotype groups scored by a read-vs-haplotype DP on the device → one
genotyping program over every window's sites (torch, on the device) →
VCF emission with the reference's INFO/FORMAT surface (DP/RO/AO/RPL/RPR/
SAF/SAR/AB/TYPE, GT:GQ:DP:RO:QR:AO:QA:GL).  Somatic mode
(bin/speedseq:835-1203) is the same engine with ``--pooled-discrete``
over [normal, tumor] plus bin/speedseq's SSC filter (:155-186).
"""

from .caller import CallerConfig, call_window  # noqa: F401
from .engine import VarConfig, run_var  # noqa: F401
from .somatic import SomaticConfig, run_somatic  # noqa: F401
