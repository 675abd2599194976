"""Diploid genotype space shared by the host caller and the device kernel.

VCF canonical diploid genotype ordering over REF + up to MAX_ALTS
alternate alleles: index(j, k) = k(k+1)/2 + j for j <= k (the GL field
ordering, VCF spec §1.6.2; freebayes emits the same order).
"""

from typing import List, Tuple

MAX_ALTS = 3
GT_PAIRS: List[Tuple[int, int]] = [
    (j, k) for k in range(MAX_ALTS + 1) for j in range(k + 1)
]
N_GT = len(GT_PAIRS)  # 10
