"""Bundled functional annotation (VEP-surface equivalent from a GFF).

Reference contract: ``speedseq -A`` pipes VCFs through Ensembl VEP with
a pinned field list (``--fields Consequence,Codons,Amino_acids,Gene,
SYMBOL,Feature,EXON,PolyPhen,SIFT,Protein_position,BIOTYPE``,
bin/speedseq:771-789; sv routing :1594-1616).  VEP is
an external Perl tool plus a multi-GB cache even there, so this module
provides the bundled equivalent for every field computable from a
user-supplied GFF3/GTF and the reference FASTA:

  Consequence, Codons, Amino_acids, Gene, SYMBOL, Feature, EXON,
  Protein_position, BIOTYPE  — computed here
  PolyPhen, SIFT             — emitted empty (learned models that ship
                               inside the VEP cache; run real VEP for
                               them)

Consequence terms follow the Sequence Ontology subset VEP uses
[external knowledge]: missense_variant, synonymous_variant,
stop_gained, stop_lost, start_lost, frameshift_variant,
inframe_insertion, inframe_deletion, splice_donor_variant,
splice_acceptor_variant, 5_prime_UTR_variant, 3_prime_UTR_variant,
intron_variant, non_coding_transcript_exon_variant,
upstream_gene_variant, downstream_gene_variant, intergenic_variant.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..formats.fasta import FastaFile

CSQ_FIELDS = ("Consequence,Codons,Amino_acids,Gene,SYMBOL,Feature,EXON,"
              "PolyPhen,SIFT,Protein_position,BIOTYPE")

_CODON = {}
_BASES = "TCAG"
_AA = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
for _i, _a in enumerate(_AA):
    _CODON["".join((_BASES[_i >> 4], _BASES[(_i >> 2) & 3],
                    _BASES[_i & 3]))] = _a

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")

UPSTREAM_DIST = 5000


@dataclass
class Transcript:
    tid: str
    gene_id: str
    symbol: str
    biotype: str
    chrom: str
    strand: str                      # '+' | '-'
    start: int = 1 << 62             # 1-based inclusive
    end: int = 0
    exons: List[Tuple[int, int]] = field(default_factory=list)
    cds: List[Tuple[int, int]] = field(default_factory=list)


def _gtf_attrs(s: str) -> Dict[str, str]:
    out = {}
    for m in re.finditer(r'(\w+)\s+"([^"]*)"', s):
        out[m.group(1)] = m.group(2)
    if not out:  # GFF3 key=value
        for part in s.split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
    return out


def read_gff(path: str) -> Dict[str, List[Transcript]]:
    """GTF or GFF3 → transcripts per chrom (exon/CDS aware)."""
    op = gzip.open if path.endswith(".gz") else open
    tx: Dict[str, Transcript] = {}
    with op(path, "rt") as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            chrom, _src, ftype, start, end, _score, strand, _phase, attrs \
                = f[:9]
            ftype = ftype.lower()
            if ftype not in ("exon", "cds", "transcript", "mrna"):
                continue
            a = _gtf_attrs(attrs)
            tid = (a.get("transcript_id") or a.get("ID") or
                   a.get("Parent") or "")
            if ftype in ("transcript", "mrna"):
                tid = a.get("transcript_id") or a.get("ID") or tid
            else:
                tid = a.get("transcript_id") or a.get("Parent") or tid
            if not tid:
                continue
            t = tx.get(tid)
            if t is None:
                t = tx[tid] = Transcript(
                    tid=tid,
                    gene_id=a.get("gene_id", a.get("gene", "")),
                    symbol=a.get("gene_name", a.get("Name",
                                                    a.get("gene_id", ""))),
                    biotype=a.get("gene_biotype",
                                  a.get("transcript_biotype",
                                        a.get("biotype", "protein_coding"))),
                    chrom=chrom, strand=strand)
            s, e = int(start), int(end)
            t.start = min(t.start, s)
            t.end = max(t.end, e)
            if ftype == "exon":
                t.exons.append((s, e))
            elif ftype == "cds":
                t.cds.append((s, e))
    by_chrom: Dict[str, List[Transcript]] = {}
    for t in tx.values():
        t.exons.sort()
        t.cds.sort()
        if not t.exons and t.cds:
            t.exons = list(t.cds)
        by_chrom.setdefault(t.chrom, []).append(t)
    for lst in by_chrom.values():
        lst.sort(key=lambda t: t.start)
    return by_chrom


class Annotator:
    """VCF record → CSQ strings (one entry per alt × transcript)."""

    def __init__(self, gff_path: str, fasta_path: str):
        self.tx = read_gff(gff_path)
        self.fa = FastaFile(fasta_path)
        self._seq_cache: Dict[str, str] = {}
        self._starts = {
            c: [t.start for t in lst] for c, lst in self.tx.items()
        }

    def close(self):
        self.fa.close()

    def _chrom_seq(self, chrom: str) -> Optional[str]:
        if chrom not in self._seq_cache:
            try:
                from ..formats.fasta import decode_bases

                self._seq_cache[chrom] = decode_bases(
                    self.fa.fetch_encoded(chrom)).decode()
            except (KeyError, ValueError):
                self._seq_cache[chrom] = ""
        return self._seq_cache[chrom] or None

    # -- coding sequence helpers -----------------------------------------
    def _coding_offset(self, t: Transcript, pos1: int) -> Optional[int]:
        """0-based offset of genomic pos1 within the transcript's coding
        sequence (strand-aware); None if not inside any CDS."""
        off = 0
        segs = t.cds if t.strand == "+" else list(reversed(t.cds))
        for s, e in segs:
            if s <= pos1 <= e:
                return off + (pos1 - s if t.strand == "+" else e - pos1)
            off += e - s + 1
        return None

    def _coding_seq(self, t: Transcript) -> str:
        seq = self._chrom_seq(t.chrom)
        if seq is None:
            return ""
        parts = [seq[s - 1 : e] for s, e in t.cds]
        cs = "".join(parts).upper()
        if t.strand == "-":
            cs = cs.translate(_COMP)[::-1]
        return cs

    # -- per (alt, transcript) annotation --------------------------------
    def _annotate_tx(self, t: Transcript, pos1: int, ref: str,
                     alt: str) -> Tuple[str, str, str, str, str]:
        """(consequence, codons, amino_acids, exon, protein_pos)."""
        if pos1 < t.start or pos1 > t.end:
            if t.strand == "+":
                before = pos1 < t.start
            else:
                before = pos1 > t.end
            return (("upstream_gene_variant" if before
                     else "downstream_gene_variant"), "", "", "", "")
        exon_i = None
        for i, (s, e) in enumerate(t.exons):
            if s <= pos1 <= e:
                exon_i = i
                break
        n_ex = len(t.exons)
        if exon_i is None:
            # intronic; splice sites are the 2 bases flanking an exon
            for s, e in t.exons:
                if pos1 in (e + 1, e + 2):
                    term = ("splice_donor_variant" if t.strand == "+"
                            else "splice_acceptor_variant")
                    return term, "", "", "", ""
                if pos1 in (s - 2, s - 1):
                    term = ("splice_acceptor_variant" if t.strand == "+"
                            else "splice_donor_variant")
                    return term, "", "", "", ""
            return "intron_variant", "", "", "", ""
        exon_no = (exon_i + 1 if t.strand == "+" else n_ex - exon_i)
        exon_str = f"{exon_no}/{n_ex}"
        if not t.cds:
            return ("non_coding_transcript_exon_variant", "", "", exon_str,
                    "")
        co = self._coding_offset(t, pos1)
        if co is None:
            cds_lo = t.cds[0][0]
            cds_hi = t.cds[-1][1]
            if (pos1 < cds_lo) == (t.strand == "+"):
                return "5_prime_UTR_variant", "", "", exon_str, ""
            return "3_prime_UTR_variant", "", "", exon_str, ""
        # coding
        if len(ref) != len(alt):
            d = abs(len(alt) - len(ref))
            if d % 3:
                term = "frameshift_variant"
            else:
                term = ("inframe_insertion" if len(alt) > len(ref)
                        else "inframe_deletion")
            return term, "", "", exon_str, str(co // 3 + 1)
        # SNV/MNP: codon + amino-acid change (first affected codon)
        cs = self._coding_seq(t)
        if not cs:
            return "missense_variant", "", "", exon_str, str(co // 3 + 1)
        ci = co // 3
        cp = co % 3
        codon = cs[ci * 3 : ci * 3 + 3]
        if len(codon) < 3:
            return "coding_sequence_variant", "", "", exon_str, str(ci + 1)
        base = alt[0].upper()
        if t.strand == "-":
            base = base.translate(_COMP)
        alt_codon = codon[:cp] + base + codon[cp + 1 :]
        aa_ref = _CODON.get(codon, "X")
        aa_alt = _CODON.get(alt_codon, "X")
        # VEP style: unchanged bases lowercase, changed uppercase
        disp_ref = "".join(
            c.upper() if i == cp else c.lower() for i, c in enumerate(codon))
        disp_alt = "".join(
            c.upper() if i == cp else c.lower()
            for i, c in enumerate(alt_codon))
        codons = f"{disp_ref}/{disp_alt}"
        aas = f"{aa_ref}/{aa_alt}" if aa_ref != aa_alt else aa_ref
        if aa_ref == aa_alt:
            term = "synonymous_variant"
        elif aa_alt == "*":
            term = "stop_gained"
        elif aa_ref == "*":
            term = "stop_lost"
        elif ci == 0 and aa_ref == "M":
            term = "start_lost"
        else:
            term = "missense_variant"
        return term, codons, aas, exon_str, str(ci + 1)

    def _annotate_span(self, t: Transcript, lo1: int, hi1: int
                       ) -> Tuple[str, str, str, str, str]:
        """Span-overlap consequence for symbolic/BND alts (the point-
        variant codon path is meaningless for them — ADVICE r4: symbolic
        alts annotated as ref→ref came out 'synonymous_variant' and BND
        bracket strings 'frameshift_variant').  Terms stay in the SO
        subset VEP emits for overlaps."""
        if hi1 < t.start or lo1 > t.end:
            if t.strand == "+":
                before = hi1 < t.start
            else:
                before = lo1 > t.end
            return (("upstream_gene_variant" if before
                     else "downstream_gene_variant"), "", "", "", "")
        if any(lo1 <= e and hi1 >= s for s, e in t.cds):
            return "coding_sequence_variant", "", "", "", ""
        for i, (s, e) in enumerate(t.exons):
            if lo1 <= e and hi1 >= s:
                n_ex = len(t.exons)
                exon_no = (i + 1 if t.strand == "+" else n_ex - i)
                if not t.cds:
                    return ("non_coding_transcript_exon_variant", "", "",
                            f"{exon_no}/{n_ex}", "")
                return ("5_prime_UTR_variant"
                        if (hi1 < t.cds[0][0]) == (t.strand == "+")
                        else "3_prime_UTR_variant",
                        "", "", f"{exon_no}/{n_ex}", "")
        return "intron_variant", "", "", "", ""

    @staticmethod
    def _is_structural_alt(alt: str) -> bool:
        return (alt.startswith("<") or alt == "*"
                or "[" in alt or "]" in alt)

    def csq(self, chrom: str, pos0: int, ref: str, alts: List[str],
            end1: Optional[int] = None) -> Optional[str]:
        """CSQ INFO value for one record (pos0 0-based), or None.

        ``end1`` (1-based inclusive, from INFO END) gives symbolic alts
        their affected span; BND bracket alts annotate the local
        breakpoint base only."""
        lst = self.tx.get(chrom, [])
        pos1 = pos0 + 1
        span_hi = max(pos1, end1) if end1 else pos1
        # candidate transcripts: span or ±UPSTREAM_DIST
        cands = [
            t for t in lst
            if t.start - UPSTREAM_DIST <= span_hi
            and pos1 <= t.end + UPSTREAM_DIST
        ]
        entries = []
        for alt in alts:
            structural = self._is_structural_alt(alt)
            if not cands:
                entries.append("|".join(
                    ["intergenic_variant"] + [""] * 10))
                continue
            for t in cands:
                if structural:
                    hi1 = pos1 if ("[" in alt or "]" in alt) else span_hi
                    cons, codons, aas, exon, ppos = self._annotate_span(
                        t, pos1, hi1)
                else:
                    cons, codons, aas, exon, ppos = self._annotate_tx(
                        t, pos1, ref, alt)
                entries.append("|".join([
                    cons, codons, aas, t.gene_id, t.symbol, t.tid, exon,
                    "", "", ppos, t.biotype,
                ]))
        return ",".join(entries) if entries else None


def annotate_vcf(path: str, gff_path: str, fasta_path: str,
                 sv_routing: bool = False) -> str:
    """Annotate a vcf.gz in place (rewrite + re-index): adds the CSQ
    INFO header + per-record CSQ entries.

    ``sv_routing`` applies the reference's sv condition
    (bin/speedseq:1595): only chr1-22/X/Y records that are BND or have
    |SVLEN| ≤ 50 kb are annotated; the rest pass through untouched."""
    import os

    from ..formats import tabix as tabix_mod
    from ..formats.vcf import VCFWriter, read_vcf

    header, records = read_vcf(path)
    header.add_info(
        "CSQ", ".", "String",
        "Consequence annotations from speedseq-tpu annotate. Format: "
        + CSQ_FIELDS.replace(",", "|"))
    ann = Annotator(gff_path, fasta_path)
    chrom_ok = {str(i) for i in range(1, 23)} | {"X", "Y"}

    def routed(rec) -> bool:
        if not sv_routing:
            return True
        c = rec.chrom.removeprefix("chr")
        if c not in chrom_ok:
            return False
        if rec.info.get("SVTYPE") == "BND":
            return True
        svlen = rec.info.get("SVLEN")
        try:
            v = int(svlen if not isinstance(svlen, list) else svlen[0])
        except (TypeError, ValueError):
            return True
        return -50_000 <= v <= 50_000

    for rec in records:
        if not routed(rec):
            continue
        end1 = None
        try:
            end1 = int(rec.info.get("END"))
        except (TypeError, ValueError):
            pass
        csq = ann.csq(rec.chrom, rec.pos, rec.ref, rec.alt, end1=end1)
        if csq:
            rec.info["CSQ"] = csq
    ann.close()
    tmp = path + ".annot.tmp.gz" if path.endswith(".gz") else path + ".annot.tmp"
    with VCFWriter(tmp, header) as w:
        for r in records:
            w.write(r)
    os.replace(tmp, path)
    if path.endswith(".gz"):
        tabix_mod.build_tbi(path)
    return path
