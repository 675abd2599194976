"""Command-line interface of the port: the speedseq driver surface.

``align``, ``var`` and ``sv`` are ported; their flags are those of the JAX
package's CLI (which mirror bin/speedseq:235-295, :540-590 and
:1205-1300) plus ``--device``.  The other subcommands, and the ``--gff``
and ``-A`` options of var and sv, say they are not ported and exit 2.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

NOT_PORTED = ("realign", "somatic")


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
    if args.seed_mode != "hash":
        print("error: --seed-mode fm is not ported yet", file=sys.stderr)
        return 2
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


def _unported_options(args) -> bool:
    """Print a note and return True when --gff or -A was given."""
    for flag, given in (("--gff", args.gff), ("-A", args.A)):
        if given:
            print(f"speedseq_tpu_torch: {args.command} {flag} is not ported "
                  "yet (use python -m speedseq_tpu)", file=sys.stderr)
            return True
    return False


def cmd_var(args) -> int:
    from .var.engine import VarConfig, run_var

    if _unported_options(args):
        return 2
    kcfg = _kconfig(args)
    out = args.o or os.path.basename(args.bams[0]).rsplit(".", 1)[0]
    output = out + ".vcf.gz"
    run_var(
        args.reference,
        args.bams,
        output,
        windows_bed=_resolve_windows(args.w, kcfg),
        config=VarConfig(
            min_qual=args.q,
            threads=args.t if args.t is not None else kcfg.threads,
            verbose=args.v),
        device=args.device,
    )
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
    from .sv.engine import SVConfig, SVSample, is_cram, run_sv

    if _unported_options(args):
        return 2
    fulls = args.B.split(",")
    spls = args.S.split(",") if args.S else [
        f.rsplit(".bam", 1)[0] + ".splitters.bam" for f in fulls
    ]
    discs = args.D.split(",") if args.D else [
        f.rsplit(".bam", 1)[0] + ".discordants.bam" for f in fulls
    ]
    samples = []
    for f, s, d in zip(fulls, spls, discs):
        if is_cram(f):
            print(f"speedseq_tpu_torch: sv: {f}: CRAM input is not ported "
                  "yet (use python -m speedseq_tpu)", file=sys.stderr)
            return 2
        name = os.path.basename(f).rsplit(".", 1)[0]
        with BAMReader(f) as rd:
            for line in rd.header.text.splitlines():
                if line.startswith("@RG") and "SM:" in line:
                    name = [x for x in line.split("\t")
                            if x.startswith("SM:")][0][3:]
                    break
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
            threads=args.t if args.t is not None else kcfg.threads,
            trim_threshold=args.r,       # lumpy -r (bin/speedseq:1243)
            cnv_bin_size=args.w,         # cnvnator -w (bin/speedseq:1248)
            verbose=args.v,
        ),
        device=args.device,
    )
    print(output)
    return 0


def cmd_not_ported(args) -> int:
    print(f"speedseq_tpu_torch: '{args.command}' is not ported yet "
          "(use python -m speedseq_tpu)", file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="speedseq_tpu_torch",
        description="PyTorch/CUDA port of speedseq_tpu (align, var and sv "
        "ported)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("align", help="align FASTQ with BWA-MEM-equivalent + dedup")
    a.add_argument("-o", metavar="STR", help="output prefix")
    a.add_argument("-t", type=int, default=None, metavar="INT",
                   help="threads for host fan-out (compat)")
    a.add_argument("-T", metavar="DIR", help="temp directory (compat)")
    a.add_argument("-K", metavar="FILE", help="speedseq.config path")
    a.add_argument("-v", action="store_true", help="verbose")
    a.add_argument("-k", action="store_true", help="keep temporary files")
    a.add_argument("--batch-size", type=int, default=None,
                   help="device batch size [config or 512]")
    a.add_argument("--seed-mode", choices=["hash", "fm"], default="hash",
                   help="seeding structure (only hash is ported)")
    a.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
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

    v = sub.add_parser("var", help="call SNVs/indels (FreeBayes-equivalent)")
    v.add_argument("-o", metavar="STR", help="output prefix")
    v.add_argument("-w", metavar="FILE", help="BED of genomic windows ('default' = shipped depth-balanced BED)")
    v.add_argument("-q", type=float, default=1.0, metavar="FLOAT", help="min QUAL [1]")
    v.add_argument("-t", type=int, default=None, metavar="INT",
                   help="threads for the per-window host phase [config or 1]")
    v.add_argument("-K", metavar="FILE", help="speedseq.config path")
    v.add_argument("-v", action="store_true", help="verbose")
    v.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    v.add_argument("--gff", metavar="FILE", help="GFF3/GTF annotation (not ported yet)")
    v.add_argument("-A", action="store_true", help="annotate with VEP (not ported yet)")
    v.add_argument("reference")
    v.add_argument("bams", nargs="+")
    v.set_defaults(func=cmd_var)

    sv = sub.add_parser("sv", help="call SVs (LUMPY+SVTyper-equivalent)")
    sv.add_argument("-o", metavar="STR", help="output prefix")
    sv.add_argument("-t", type=int, default=None, metavar="INT",
                    help="threads for the per-sample genotyping fan-out "
                    "[config or 1]")
    sv.add_argument("-T", metavar="DIR", help="temp directory (compat)")
    sv.add_argument("-K", metavar="FILE", help="speedseq.config path")
    sv.add_argument("-v", action="store_true", help="verbose")
    sv.add_argument("-k", action="store_true", help="keep temporary files")
    sv.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    sv.add_argument("-B", required=True, metavar="FILE", help="full BAM(s), comma separated")
    sv.add_argument("-S", metavar="FILE", help="splitters BAM(s)")
    sv.add_argument("-D", metavar="FILE", help="discordants BAM(s)")
    sv.add_argument("-R", metavar="FILE", help="reference fasta (for -d)")
    sv.add_argument("-x", metavar="FILE", help="exclude BED ('default' = shipped LUMPY exclude BED)")
    sv.add_argument("--gff", metavar="FILE", help="GFF3/GTF annotation (not ported yet)")
    sv.add_argument("-g", action="store_true", help="genotype breakends")
    sv.add_argument("-d", action="store_true", help="read-depth CNV annotation")
    sv.add_argument("-w", type=int, default=100, metavar="INT", help="CNV window [100]")
    sv.add_argument("-P", action="store_true", help="output probability curves")
    sv.add_argument("-m", type=int, default=4, metavar="INT", help="min sample weight [4]")
    sv.add_argument("-r", type=float, default=0.0, metavar="FLOAT", help="trim threshold [0]")
    sv.add_argument("-A", action="store_true", help="annotate with VEP (not ported yet)")
    sv.set_defaults(func=cmd_sv)

    for name in NOT_PORTED:
        s = sub.add_parser(name, help="not ported yet", add_help=False)
        s.set_defaults(func=cmd_not_ported)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.func is not cmd_not_ported:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
