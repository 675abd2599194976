"""Indel normalization: left-align and minimalize allele representations.

The canonical variant-normalization algorithm (vt/bcftools norm semantics
[external knowledge: Tan et al. 2015]); needed so indels in repeat tracts
get one canonical position regardless of where the aligner's DP placed
the gap.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BASES = "ACGTN"


def primitives(pos: int, ref: str, alt: str):
    """Decompose an MNP/complex allele into primitive variants
    (vcflib vcfallelicprimitives semantics [external knowledge], used by
    consumers comparing haplotype-caller output against per-site truth).

    Equal-length alleles decompose into per-base SNVs; length-changing
    alleles are returned whole (after shared prefix/suffix trimming).
    """
    # trim shared suffix then prefix (parsimony)
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt = ref[1:], alt[1:]
        pos += 1
    if len(ref) == len(alt):
        return [
            (pos + i, ref[i], alt[i])
            for i in range(len(ref))
            if ref[i] != alt[i]
        ]
    return [(pos, ref, alt)]


def left_align(
    genome: np.ndarray, pos: int, ref: str, alt: str
) -> Tuple[int, str, str]:
    """Left-align + minimalize (pos 0-based; genome = encoded uint8)."""
    if len(ref) == len(alt) == 1:
        return pos, ref, alt
    ref_l, alt_l = ref, alt
    while True:
        if len(ref_l) > 0 and len(alt_l) > 0 and ref_l[-1] == alt_l[-1] and (
            len(ref_l) > 1 or len(alt_l) > 1
        ):
            ref_l, alt_l = ref_l[:-1], alt_l[:-1]
            continue
        if (len(ref_l) == 0 or len(alt_l) == 0) and pos > 0:
            pos -= 1
            b = _BASES[min(int(genome[pos]), 4)]
            ref_l, alt_l = b + ref_l, b + alt_l
            continue
        break
    while len(ref_l) > 1 and len(alt_l) > 1 and ref_l[0] == alt_l[0]:
        ref_l, alt_l = ref_l[1:], alt_l[1:]
        pos += 1
    return pos, ref_l, alt_l
