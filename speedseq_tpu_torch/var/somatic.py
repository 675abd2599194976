"""speedseq somatic equivalent: tumor/normal pooled calling + SSC filter.

Reference contract (bin/speedseq:835-1203):
- FreeBayes over [normal, tumor] with ``--pooled-discrete
  --genotype-qualities --min-repeat-entropy 1 --min-alternate-fraction
  0.05 --min-alternate-count 2`` (:1059-1067)
- bin/speedseq's awk somatic filter (:155-186, exact math reproduced in
  ``ssc_score``): LOD_NORM = NGL[0]-NGL[1]; LOD_TUMOR = max(TGL[1]-TGL[0],
  TGL[2]-TGL[0]); SSC = LOD_TUMOR + LOD_NORM.  PASS iff SSC ≥ 18 and
  normal GT 0/0; else keep non-PASS when QUAL ≥ MINQUAL (1e-5), normal
  0/0 and tumor ≠ 0/0 (unless -o only-somatic)
- header gains ##INFO SSC (:1087); a GEMINI PED file is emitted (:1186).

The device work (the haplotype scan and the genotyping program with its
pooled-discrete branch) runs on the run's device: cuda unless the caller
asks for cpu.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..formats.bam import BAMReader
from ..formats.vcf import VCFRecord
from .caller import CallerConfig
from .engine import VarConfig, run_var


@dataclass
class SomaticConfig:
    min_qual: float = 1e-5        # speedseq somatic -q default (:888)
    ssc_threshold: float = 18.0   # -s default (:889)
    only_somatic: bool = False    # -o flag
    threads: int = 1              # -t window fan-out
    caller: CallerConfig = field(
        default_factory=lambda: CallerConfig(
            min_alternate_fraction=0.05,  # bin/speedseq:1064
            min_alternate_count=2,        # bin/speedseq:1065
            pooled_discrete=True,
        )
    )
    verbose: bool = False


def ssc_score(normal_gl: List[float], tumor_gl: List[float]) -> float:
    """SSC from GL triples — exact reproduction of bin/speedseq:166-173."""
    lod_norm = normal_gl[0] - normal_gl[1]
    lod_tumor_het = tumor_gl[1] - tumor_gl[0]
    lod_tumor_hom = tumor_gl[2] - tumor_gl[0]
    lod_tumor = max(lod_tumor_het, lod_tumor_hom)
    return lod_tumor + lod_norm


def somatic_filter(cfg: SomaticConfig):
    """Record filter closure implementing the awk filter (:155-186).

    Sample order contract: column 0 = normal, column 1 = tumor
    (bin/speedseq:1066: freebayes gets normal then tumor)."""

    def fn(rec: VCFRecord) -> Optional[VCFRecord]:
        if len(rec.samples) < 2:
            return None
        normal, tumor = rec.samples[0], rec.samples[1]
        ngl = [float(x) for x in _gl_of(normal)]
        tgl = [float(x) for x in _gl_of(tumor)]
        if len(ngl) < 3 or len(tgl) < 3:
            return None
        ssc = ssc_score(ngl, tgl)
        normal_ref = str(normal.get("GT", "")) .startswith("0/0")
        tumor_ref = str(tumor.get("GT", "")).startswith("0/0")
        # awk prepends SSC to INFO — keep it first like the reference
        info = {"SSC": round(ssc, 4)}
        info.update(rec.info)
        if ssc >= cfg.ssc_threshold and normal_ref:
            rec.filter = "PASS"
            rec.info = info
            return rec
        if (
            not cfg.only_somatic
            and (rec.qual or 0) >= cfg.min_qual
            and normal_ref
            and not tumor_ref
        ):
            rec.info = info
            return rec
        return None

    return fn


def _gl_of(sample: dict) -> List[float]:
    gl = sample.get("GL", [])
    if isinstance(gl, str):
        return [float(x) for x in gl.split(",") if x not in (".", "")]
    if isinstance(gl, (list, tuple)):
        return [float(x) for x in gl]
    return []


def write_ped(path: str, tumor_sample: str, normal_sample: str, project: str = "sample"):
    """GEMINI PED output (bin/speedseq:1179-1186 format)."""
    with open(path, "w") as fh:
        fh.write("#family_id\tname\tpaternal_id\tmaternal_id\tsex\tphenotype\n")
        fh.write(f"1\t{normal_sample}\t-9\t-9\t0\t1\n")
        fh.write(f"1\t{tumor_sample}\t-9\t-9\t0\t2\n")


def run_somatic(
    reference: str,
    normal_bam: str,
    tumor_bam: str,
    output: str,
    windows_bed: Optional[str] = None,
    config: SomaticConfig = SomaticConfig(),
    device=None,
) -> str:
    """Tumor/normal somatic calling on ``device`` (cuda unless the caller
    asks for cpu); returns output path (+ .ped)."""
    cfg = config
    var_cfg = VarConfig(
        min_qual=0.0,                  # somatic has its own QUAL handling
        caller=cfg.caller,
        apply_balance_filter=False,    # somatic mode has no RPR/RPL filter
        threads=cfg.threads,
        verbose=cfg.verbose,
    )
    out = run_var(
        reference,
        [normal_bam, tumor_bam],       # order contract: normal, tumor
        output,
        windows_bed=windows_bed,
        config=var_cfg,
        record_filter=somatic_filter(cfg),
        _somatic_header=True,          # ##INFO SSC (bin/speedseq:1087)
        device=device,
    )
    # PED for GEMINI loading
    def sample_of(p):
        rd = BAMReader(p)
        for line in rd.header.text.splitlines():
            if line.startswith("@RG"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
                rd.close()
                return d.get("SM", p)
        rd.close()
        return p

    ped = output[: -len(".vcf.gz")] + ".ped" if output.endswith(".vcf.gz") else output + ".ped"
    write_ped(ped, sample_of(tumor_bam), sample_of(normal_bam))
    return out
