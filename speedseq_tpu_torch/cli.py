"""Command-line interface of the port: the speedseq driver surface.

All five subcommands are ported: ``align``, ``realign``, ``var``,
``somatic`` and ``sv``.  Their flags are those of the JAX package's CLI
(which mirror bin/speedseq:235-295, :1690-1754, :540-590, :882-946 and
:1205-1300) plus ``--device`` (cuda unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def _warn_vep(args) -> None:
    """-A is parsed for reference-CLI compatibility but VEP is an external
    annotator even in the reference (README.md:96-109); run it on the
    emitted vcf.gz directly."""
    if getattr(args, "A", False):
        print(
            "warning: -A (Ensembl VEP) is not bundled; use --gff FILE for "
            "the bundled GFF-driven annotator (CSQ fields), or run VEP on "
            "the output vcf.gz directly",
            file=sys.stderr,
        )


def _kconfig(args):
    """The -K speedseq.config equivalent; explicit CLI flags take
    precedence over config-file values."""
    from .config import SpeedseqConfig

    return SpeedseqConfig.load(getattr(args, "K", None))


def _parse_insert_override(s: str):
    parts = [float(x) for x in s.split(",")]
    mean = parts[0]
    std = parts[1] if len(parts) > 1 else 0.1 * mean
    mx = int(parts[2]) if len(parts) > 2 else int(mean + 4 * std)
    mn = int(parts[3]) if len(parts) > 3 else 0
    return (mean, std, mx, mn)


def _annotate(output: str, gff: str, fasta: str, sv_routing=False) -> None:
    """--gff: the bundled annotator over the written VCF (timer
    ``annotate``)."""
    from .utils.metrics import metrics
    from .var.annotate import annotate_vcf

    with metrics.timer("annotate"):
        annotate_vcf(output, gff, fasta, sv_routing=sv_routing)


def _threads(args, kcfg) -> int:
    return args.t if args.t is not None else kcfg.threads


def _align_config(args):
    from .align.pipeline import AlignConfig

    kcfg = _kconfig(args)
    return AlignConfig(
        batch_size=args.batch_size or kcfg.batch_size,
        rg_string=args.R,
        include_dups_in_side=args.i,
        max_split_count=args.c,
        min_non_overlap=args.m,
        insert_override=_parse_insert_override(args.I) if args.I else None,
        seed_mode=args.seed_mode,
        verbose=args.v,
    )


def cmd_align(args) -> int:
    from .align.pipeline import align_fastq

    if not args.R:
        print("error: -R readgroup string is required", file=sys.stderr)
        return 1
    out = args.o or os.path.basename(args.fastq1).split(".")[0]
    outputs = align_fastq(
        args.reference,
        args.fastq1,
        fq2=args.fastq2,
        interleaved=args.p,
        out_prefix=out,
        config=_align_config(args),
        device=args.device,
    )
    for v in outputs.values():
        print(v)
    return 0


def cmd_realign(args) -> int:
    from .align.realign import realign

    out = args.o or os.path.basename(args.bams[0]).rsplit(".", 1)[0] + ".realign"
    outputs = realign(
        args.reference, args.bams, out, config=_align_config(args),
        rename=args.n, device=args.device,
    )
    for v in outputs.values():
        print(v)
    return 0


def _resolve_windows(w, kcfg):
    """-w 'default' resolves the shipped depth-balanced window BED
    (ceph18.b37.include.2014-01-15.bed, README.md:153-155) via the
    config's annotations_dir."""
    if w == "default":
        p = kcfg.default_windows()
        if p is None:
            raise SystemExit(
                "speedseq_tpu_torch: no default windows BED found under "
                f"{kcfg.annotations_dir} (set annotations_dir via -K)")
        return p
    return w or kcfg.windows_bed


def cmd_var(args) -> int:
    from .var.engine import VarConfig, run_var

    _warn_vep(args)
    kcfg = _kconfig(args)
    out = args.o or os.path.basename(args.bams[0]).rsplit(".", 1)[0]
    output = out + ".vcf.gz"
    run_var(
        args.reference,
        args.bams,
        output,
        windows_bed=_resolve_windows(args.w, kcfg),
        config=VarConfig(
            min_qual=args.q, threads=_threads(args, kcfg), verbose=args.v),
        device=args.device,
    )
    if args.gff:
        _annotate(output, args.gff, args.reference)
    print(output)
    return 0


def cmd_somatic(args) -> int:
    from .var.caller import CallerConfig
    from .var.somatic import SomaticConfig, run_somatic

    _warn_vep(args)
    kcfg = _kconfig(args)
    out = args.o or os.path.basename(args.tumor_bam).rsplit(".", 1)[0]
    output = out + ".vcf.gz"
    run_somatic(
        args.reference,
        args.normal_bam,
        args.tumor_bam,
        output,
        windows_bed=_resolve_windows(args.w, kcfg),
        config=SomaticConfig(
            min_qual=args.q,
            ssc_threshold=args.S,
            only_somatic=args.only_somatic,
            threads=_threads(args, kcfg),
            caller=CallerConfig(
                min_alternate_fraction=args.F,
                min_alternate_count=args.C,
                pooled_discrete=True,
            ),
            verbose=args.v,
        ),
        device=args.device,
    )
    if args.gff:
        _annotate(output, args.gff, args.reference)
    print(output)
    return 0


def _resolve_exclude(x, kcfg):
    """-x 'default' resolves the shipped LUMPY exclude BED
    (annotations/ceph18.b37.lumpy.exclude.2014-01-15.bed)."""
    if x == "default":
        p = kcfg.default_exclude()
        if p is None:
            raise SystemExit(
                "speedseq_tpu_torch: no default exclude BED found under "
                f"{kcfg.annotations_dir} (set annotations_dir via -K)")
        return p
    return x or kcfg.exclude_bed


def cmd_sv(args) -> int:
    from .formats.bam import BAMReader
    from .formats.cram import CRAMReader, is_cram
    from .sv.engine import SVConfig, SVSample, run_sv

    _warn_vep(args)
    fulls = args.B.split(",")
    spls = args.S.split(",") if args.S else [
        f.rsplit(".bam", 1)[0] + ".splitters.bam" for f in fulls
    ]
    discs = args.D.split(",") if args.D else [
        f.rsplit(".bam", 1)[0] + ".discordants.bam" for f in fulls
    ]
    samples = []
    for f, s, d in zip(fulls, spls, discs):
        name = os.path.basename(f).rsplit(".", 1)[0]
        rd = CRAMReader(f) if is_cram(f) else BAMReader(f)
        try:
            for line in rd.header.text.splitlines():
                if line.startswith("@RG") and "SM:" in line:
                    name = [x for x in line.split("\t")
                            if x.startswith("SM:")][0][3:]
                    break
        finally:
            rd.close()
        samples.append(SVSample(name, f, s, d))
    kcfg = _kconfig(args)
    out = args.o or os.path.basename(fulls[0]).rsplit(".", 1)[0]
    output = out + ".sv.vcf.gz"
    run_sv(
        samples,
        output,
        SVConfig(
            min_weight=args.m,
            genotype=args.g,
            annotate_depth=args.d,
            prob_curves=args.P,
            exclude_bed=_resolve_exclude(args.x, kcfg),
            reference=args.R,
            threads=_threads(args, kcfg),
            trim_threshold=args.r,       # lumpy -r (bin/speedseq:1243)
            cnv_bin_size=args.w,         # cnvnator -w (bin/speedseq:1248)
            verbose=args.v,
        ),
        device=args.device,
    )
    if args.gff:
        if not args.R:
            print("error: --gff annotation needs -R reference",
                  file=sys.stderr)
            return 1
        _annotate(output, args.gff, args.R, sv_routing=True)
    print(output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="speedseq_tpu_torch",
        description="PyTorch/CUDA port of speedseq_tpu "
        "(align | var | somatic | sv | realign)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-o", metavar="STR", help="output prefix")
        sp.add_argument("-t", type=int, default=None, metavar="INT",
                        help="threads for host fan-out [config or 1]")
        sp.add_argument("-T", metavar="DIR", help="temp directory (compat)")
        sp.add_argument("-K", metavar="FILE", help="speedseq.config path")
        sp.add_argument("-v", action="store_true", help="verbose")
        sp.add_argument("-k", action="store_true",
                        help="keep temporary files (compat)")
        sp.add_argument("--batch-size", type=int, default=None,
                        help="device batch size [config or 512]")
        sp.add_argument("--seed-mode", choices=["hash", "fm"], default="hash",
                        help="seeding structure: k-mer hash index or "
                        "FM-index SMEM search [hash]")
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")

    a = sub.add_parser("align", help="align FASTQ with BWA-MEM-equivalent + dedup")
    common(a)
    a.add_argument("-R", metavar="STR", help="read group header line (required)")
    a.add_argument("-p", action="store_true", help="interleaved paired-end input")
    a.add_argument("-I", metavar="FLOAT[,...]", help="insert distro mean,std,max,min")
    a.add_argument("-i", action="store_true", help="include duplicates in splitters/discordants")
    a.add_argument("-c", type=int, default=2, metavar="INT", help="max split alignments for splitter file")
    a.add_argument("-m", type=int, default=20, metavar="INT", help="min non-overlap for splitter file")
    a.add_argument("-M", type=int, default=20, metavar="INT", help="sort memory GB (compat)")
    a.add_argument("reference")
    a.add_argument("fastq1")
    a.add_argument("fastq2", nargs="?")
    a.set_defaults(func=cmd_align)

    r = sub.add_parser("realign", help="realign BAM(s) preserving read groups")
    common(r)
    r.add_argument("-R", metavar="STR", help="read group override")
    r.add_argument("-I", metavar="FLOAT[,...]", help="insert distro override")
    r.add_argument("-n", action="store_true", help="rename reads")
    r.add_argument("-i", action="store_true", help="include duplicates in splitters/discordants")
    r.add_argument("-c", type=int, default=2, metavar="INT")
    r.add_argument("-m", type=int, default=20, metavar="INT")
    r.add_argument("-M", type=int, default=20, metavar="INT")
    r.add_argument("reference")
    r.add_argument("bams", nargs="+")
    r.set_defaults(func=cmd_realign)

    v = sub.add_parser("var", help="call SNVs/indels (FreeBayes-equivalent)")
    common(v)
    v.add_argument("-w", metavar="FILE", help="BED of genomic windows ('default' = shipped depth-balanced BED)")
    v.add_argument("--gff", metavar="FILE",
                   help="GFF3/GTF for bundled functional annotation "
                   "(CSQ fields; VEP-surface, var/annotate.py)")
    v.add_argument("-q", type=float, default=1.0, metavar="FLOAT", help="min QUAL [1]")
    v.add_argument("-A", action="store_true", help="annotate with VEP (external; not bundled)")
    v.add_argument("reference")
    v.add_argument("bams", nargs="+")
    v.set_defaults(func=cmd_var)

    s = sub.add_parser("somatic", help="tumor/normal somatic calling")
    common(s)
    s.add_argument("-w", metavar="FILE")
    s.add_argument("--gff", metavar="FILE",
                   help="GFF3/GTF for bundled functional annotation")
    s.add_argument("-q", type=float, default=1e-5, metavar="FLOAT",
                   help="min QUAL for non-passing somatic [1e-5]")
    s.add_argument("-F", type=float, default=0.05, metavar="FLOAT",
                   help="min alternate fraction [0.05]")
    s.add_argument("-C", type=int, default=2, metavar="INT",
                   help="min alternate count [2]")
    s.add_argument("-S", type=float, default=18.0, metavar="FLOAT",
                   help="min SSC for PASS [18]")
    s.add_argument("--only-somatic", action="store_true")
    s.add_argument("-A", action="store_true")
    s.add_argument("reference")
    s.add_argument("normal_bam")
    s.add_argument("tumor_bam")
    s.set_defaults(func=cmd_somatic)

    sv = sub.add_parser("sv", help="call SVs (LUMPY+SVTyper-equivalent)")
    common(sv)
    sv.add_argument("-B", required=True, metavar="FILE", help="full BAM(s) or CRAM(s), comma separated")
    sv.add_argument("-S", metavar="FILE", help="splitters BAM(s)")
    sv.add_argument("-D", metavar="FILE", help="discordants BAM(s)")
    sv.add_argument("-R", metavar="FILE", help="reference fasta (for -d, --gff and CRAM)")
    sv.add_argument("-x", metavar="FILE", help="exclude BED ('default' = shipped LUMPY exclude BED)")
    sv.add_argument("--gff", metavar="FILE",
                    help="GFF3/GTF for bundled functional annotation "
                    "(reference routing: chr1-22/X/Y, BND or |SVLEN|<=50kb)")
    sv.add_argument("-g", action="store_true", help="genotype breakends")
    sv.add_argument("-d", action="store_true", help="read-depth CNV annotation")
    sv.add_argument("-w", type=int, default=100, metavar="INT", help="CNV window [100]")
    sv.add_argument("-P", action="store_true", help="output probability curves")
    sv.add_argument("-m", type=int, default=4, metavar="INT", help="min sample weight [4]")
    sv.add_argument("-r", type=float, default=0.0, metavar="FLOAT", help="trim threshold [0]")
    sv.add_argument("-A", action="store_true", help="annotate with VEP (external; not bundled)")
    sv.set_defaults(func=cmd_sv)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    """Run one subcommand.  ``SSQ_TORCH_TRACE=<dir>`` records it with
    ``torch.profiler`` (the device too, on a card) and writes a Chrome
    trace ``<dir>/<subcommand>-<pid>-<ms>.json``, the program's spans
    (``ssq.<name>``) among its events."""
    args = build_parser().parse_args(argv)
    trace_dir = os.environ.get("SSQ_TORCH_TRACE")
    if not trace_dir:
        return args.func(args)
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        rc = args.func(args)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir,
        f"{args.command}-{os.getpid()}-{int(time.time() * 1000)}.json"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
