"""speedseq sv equivalent: BAM triples → genotyped, annotated sv.vcf.gz.

Orchestration per the reference (bin/speedseq:1205-1641):
1. insert stats per sample (pairend_distro semantics)
2. evidence from discordants + splitters, exclude-BED filtered
3. LUMPY-style clustering (min weight 4, -P probability curves)
4. optional per-sample SVTyper genotyping (-g)
5. optional CNVnator-style read-depth CN annotation (-d)
6. header + coordinate sort + bgzip + tabix (:1622-1629)

Device work (the cluster sweep and curve combination, the SVTyper
program, depth binning, GC correction and mean-shift) runs on the run's
device: cuda unless the caller asks for cpu.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..formats import tabix as tabix_mod
from ..formats.bam import BAMReader, BAMWriter
from ..formats.bed import ExcludeMask, read_bed
from ..formats.vcf import VCFHeader, VCFRecord, VCFWriter
from ..utils.metrics import metrics
from .cluster import SVCall, cluster_breakpoints
from .cnv import DepthProfile
from .evidence import BND, DEL, InsertStats, collect_evidence
from .svtyper import GenotypeResult, SVGenotyper


@dataclass
class SVSample:
    name: str
    full: str
    splitters: str
    discordants: str


@dataclass
class SVConfig:
    min_weight: int = 4            # lumpy -m (bin/speedseq:1242)
    genotype: bool = True          # -g svtyper pass (:1488-1505)
    annotate_depth: bool = False   # -d cnvnator pass (:1509-1551)
    prob_curves: bool = True       # lumpy -P (:1312-1313)
    exclude_bed: Optional[str] = None
    reference: Optional[str] = None  # needed for -d
    threads: int = 1               # -t: per-sample genotyping fan-out
    trim_threshold: float = 0.0    # lumpy -r (:1243; pinned default 0)
    cnv_bin_size: int = 100        # cnvnator window -w (:1248)
    verbose: bool = False


def build_sv_header(
    contigs: List[Tuple[str, int]], samples: List[str], cfg: SVConfig
) -> VCFHeader:
    h = VCFHeader.build(contigs, samples, source="speedseq_tpu_torch-sv (LUMPY-equivalent)")
    h.add_info("SVTYPE", "1", "String", "Type of structural variant")
    h.add_info("SVLEN", ".", "Integer", "Difference in length between REF and ALT alleles")
    h.add_info("END", "1", "Integer", "End position of the variant described in this record")
    h.add_info("STRANDS", ".", "String", "Strand orientation of the adjacency in BEDPE format (DEL:+-, DUP:-+, INV:++/--)")
    h.add_info("IMPRECISE", "0", "Flag", "Imprecise structural variation")
    h.add_info("CIPOS", "2", "Integer", "Confidence interval around POS for imprecise variants")
    h.add_info("CIEND", "2", "Integer", "Confidence interval around END for imprecise variants")
    h.add_info("CIPOS95", "2", "Integer", "Confidence interval (95%) around POS for imprecise variants")
    h.add_info("CIEND95", "2", "Integer", "Confidence interval (95%) around END for imprecise variants")
    h.add_info("MATEID", ".", "String", "ID of mate breakends")
    h.add_info("EVENT", "1", "String", "ID of event associated to breakend")
    h.add_info("SU", ".", "Integer", "Number of pieces of evidence supporting the variant across all samples")
    h.add_info("PE", ".", "Integer", "Number of paired-end reads supporting the variant across all samples")
    h.add_info("SR", ".", "Integer", "Number of split reads supporting the variant across all samples")
    if cfg.prob_curves:
        h.add_info("PRPOS", ".", "String", "LUMPY probability curve of the POS breakend")
        h.add_info("PREND", ".", "String", "LUMPY probability curve of the END breakend")
    h.add_alt("DEL", "Deletion")
    h.add_alt("DUP", "Duplication")
    h.add_alt("INV", "Inversion")
    h.add_format("GT", "1", "String", "Genotype")
    h.add_format("SU", "1", "Integer", "Number of pieces of evidence supporting the variant")
    h.add_format("PE", "1", "Integer", "Number of paired-end reads supporting the variant")
    h.add_format("SR", "1", "Integer", "Number of split reads supporting the variant")
    h.add_format("GQ", "1", "Integer", "Genotype quality")
    h.add_format("SQ", "1", "Float", "Phred-scaled probability that this site is variant (non-reference) in this sample")
    h.add_format("GL", "G", "Float", "Genotype Likelihood, log10-scaled")
    h.add_format("DP", "1", "Integer", "Read depth")
    h.add_format("RO", "1", "Integer", "Reference allele observation count, with partial observations recorded fractionally")
    h.add_format("AO", "A", "Integer", "Alternate allele observations, with partial observations recorded fractionally")
    h.add_format("RS", "1", "Integer", "Reference allele split-read observation count, with partial observations recorded fractionally")
    h.add_format("AS", "A", "Integer", "Alternate allele split-read observation count, with partial observations recorded fractionally")
    h.add_format("RP", "1", "Integer", "Reference allele paired-end observation count, with partial observations recorded fractionally")
    h.add_format("AP", "A", "Integer", "Alternate allele paired-end observation count, with partial observations recorded fractionally")
    h.add_format("AB", "A", "Float", "Allele balance, fraction of observations from alternate allele")
    if cfg.annotate_depth:
        h.add_format("CN", "1", "Float", "Copy number of structural variant segment")  # annotate_rd.py
    return h


def _strands_str(call: SVCall) -> str:
    s = {0: "+", 1: "-"}
    return f"{s[call.strand1]}{s[call.strand2]}:{call.su}"


def _prob_str(p: np.ndarray) -> str:
    return ",".join(f"{x:.3g}" for x in p)


def _sample_format(gr: Optional[GenotypeResult], call: SVCall, si: int,
                   cn: Optional[float]) -> Dict[str, object]:
    su = call.sample_support.get(si, 0)
    pe = min(call.pe, su)
    sr = su - pe if su > pe else 0
    d: Dict[str, object] = {"SU": su, "PE": pe, "SR": sr}
    if gr is not None:
        d.update(
            GT=gr.gt, GQ=gr.gq, SQ=gr.sq,
            GL=[int(round(x)) for x in gr.gl],
            DP=gr.dp, RO=gr.ro, AO=gr.ao,
            RS=gr.rs, AS=gr.as_, RP=gr.rp, AP=gr.ap, AB=gr.ab,
        )
    else:
        d.update(GT="./.")
    if cn is not None:
        d["CN"] = cn
    return d


def extract_side_bams(
    full_bam: str, splitters_out: Optional[str], discordants_out: Optional[str],
    max_split_count: int = 2,
) -> None:
    """lumpyexpress front-end behavior: when a sample arrives without
    splitter/discordant BAMs, regenerate them from the full BAM — the
    reference name-groups and re-runs samblaster extraction
    (bin/speedseq:1377-1386).  Here one columnar pass classifies:

    - splitters: non-duplicate records carrying an SA tag with at most
      ``max_split_count`` total alignments (samblaster --maxSplitCount 2)
    - discordants: primary, paired, both-mapped, non-proper-pair records
      (samblaster --discordantFile semantics)

    Either output may be None to skip generating that side channel (the
    user supplied it already — never overwrite a user input).
    """
    from ..formats.sam import (
        FDUP, FMUNMAP, FPAIRED, FPROPER_PAIR, FSECONDARY, FSUPPLEMENTARY,
        FUNMAP,
    )
    from .. import native
    from .columnar import read_bam_columns, record_sizes, ztag_strings

    refs, cols, blob = read_bam_columns(full_bam, with_blob=True)
    flags = cols.flag.astype(np.int64)
    base = (flags & (FDUP | FSECONDARY | FUNMAP)) == 0
    sizes = record_sizes(cols)
    starts = np.zeros(cols.n, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    with BAMReader(full_bam) as rd0:
        header = rd0.header
    if splitters_out:
        sa_off, sa_len = ztag_strings(cols, "SA")
        # pieces = segments in SA + this record; samblaster
        # --maxSplitCount caps the total piece count
        semis = np.zeros(cols.n, np.int64)
        has = sa_off >= 0
        if has.any():
            semi_mask = cols.aux_blob == ord(";")
            csum = np.concatenate(
                [[0], np.cumsum(semi_mask.astype(np.int64))])
            s0 = np.where(has, sa_off, 0)
            s1 = s0 + np.where(has, sa_len, 0)
            semis = csum[s1] - csum[s0]
            last_semi = has & (sa_len > 0) & (
                cols.aux_blob[np.maximum(s1 - 1, 0)] == ord(";"))
            semis = semis - last_semi.astype(np.int64)
        spl_mask = base & has & (semis + 2 <= max_split_count)
        with BAMWriter(splitters_out, header) as w:
            w.write_blob(native.gather_records(
                blob, starts, sizes, np.nonzero(spl_mask)[0]).tobytes())
    if discordants_out:
        disc_mask = (
            base & ((flags & FSUPPLEMENTARY) == 0)
            & ((flags & FPAIRED) != 0)
            & ((flags & FMUNMAP) == 0)
            & ((flags & FPROPER_PAIR) == 0)
        )
        with BAMWriter(discordants_out, header) as w:
            w.write_blob(native.gather_records(
                blob, starts, sizes, np.nonzero(disc_mask)[0]).tobytes())


def _ensure_side_bams(samples: List[SVSample], verbose: bool) -> None:
    """Regenerate ONLY the missing side BAM(s) per sample; an existing
    user-supplied file is never reused as a write target (it would be
    destructively overwritten with autogen content)."""
    for s in samples:
        if os.path.exists(s.splitters) and os.path.exists(s.discordants):
            continue
        base = s.full[:-4] if s.full.endswith(".bam") else s.full
        spl_out = disc_out = None
        if not os.path.exists(s.splitters):
            s.splitters = spl_out = base + ".splitters.autogen.bam"
        if not os.path.exists(s.discordants):
            s.discordants = disc_out = base + ".discordants.autogen.bam"
        if verbose:
            which = "+".join(
                n for n, o in (("splitters", spl_out), ("discordants", disc_out)) if o
            )
            print(f"[sv] extracting {which} from {s.full}")
        extract_side_bams(s.full, spl_out, disc_out)


def _convert_cram_inputs(samples: List[SVSample], cfg: SVConfig) -> None:
    """CRAM full-BAM inputs decode to BAM first (the reference's sv
    accepts CRAM via its lumpy cram branch, bin/speedseq:97-134;
    formats/cram.py is our decoder).  Requires -R/reference unless the
    CRAM embeds its reference."""
    from ..formats.cram import cram_to_bam, is_cram

    for s in samples:
        if not os.path.exists(s.full) or not is_cram(s.full):
            continue
        out = s.full + ".decoded.bam"
        if cfg.verbose:
            print(f"[sv] decoding CRAM input {s.full} -> {out}")
        cram_to_bam(s.full, out, reference=cfg.reference)
        s.full = out


def run_sv(
    samples: List[SVSample],
    output: str,
    config: SVConfig = SVConfig(),
    device=None,
    _shard: Optional[Tuple[int, int]] = None,
    _exchange=None,
) -> Optional[str]:
    """Run the sv module on ``device`` (cuda unless the caller asks for
    cpu); returns the output path.

    ``_shard=(P, pid)`` restricts the per-sample work (SVTyper genotyping
    and CNV depth) to the samples with ``si % P == pid``: the
    multi-process counterpart of the reference's per-sample svtyper /
    cnvnator loops (bin/speedseq:1490-1531).  Insert stats, evidence and
    clustering are deterministic and computed alike on every process;
    the per-sample results are exchanged as fixed-width float64 matrices
    over ``_exchange``, and process 0 writes the VCF (the others return
    None)."""
    cfg = config
    device = resolve_device(device)
    P_, pid_ = _shard if _shard is not None else (1, 0)

    def _local(si: int) -> bool:
        return si % P_ == pid_

    t_start = time.time()
    _convert_cram_inputs(samples, cfg)
    _ensure_side_bams(samples, cfg.verbose)
    with metrics.timer("sv.insert_stats"):
        stats = [InsertStats.from_bam(s.full) for s in samples]
    if cfg.verbose:
        for s, st in zip(samples, stats):
            print(f"[sv] {s.name}: insert mean={st.mean:.1f} std={st.std:.1f}")
    exclude = None
    if cfg.exclude_bed:
        exclude = ExcludeMask(read_bed(cfg.exclude_bed))

    with BAMReader(samples[0].full) as rd:
        refs = rd.header.refs
    ref_names = [n for n, _ in refs]

    # start the genotypers' whole-BAM columnar decode now, overlapped with
    # evidence collection and clustering: the decode is host work with the
    # GIL released (native codec), the same producer/consumer overlap the
    # reference gets from running lumpy and the svtyper input prep as
    # separate processes (bin/speedseq:1473-1505)
    genotypers: List[Optional[SVGenotyper]] = [None] * len(samples)
    warm_thread = None
    warm_error: List[BaseException] = []
    if cfg.genotype:
        genotypers = [SVGenotyper(s.full, st, device=device)
                      if _local(si) else None
                      for si, (s, st) in enumerate(zip(samples, stats))]

        def _warm():
            try:
                for g in genotypers:
                    if g is not None:
                        g._columns()
            except BaseException as e:     # re-raised on the main thread
                warm_error.append(e)

        warm_thread = threading.Thread(target=_warm, daemon=True)
        warm_thread.start()

    with metrics.timer("sv.evidence"):
        evidence = collect_evidence(
            [s.discordants for s in samples],
            [s.splitters for s in samples],
            stats,
            exclude=exclude,
            ref_names=ref_names,
        )
    with metrics.timer("sv.cluster"):
        calls = cluster_breakpoints(
            evidence, min_weight=cfg.min_weight, trim=cfg.trim_threshold,
            device=device)
    metrics.add("sv.evidence.pe", sum(1 for b in evidence if not b.is_split))
    metrics.add("sv.evidence.sr", sum(1 for b in evidence if b.is_split))
    metrics.add("sv.calls", len(calls))
    if cfg.verbose:
        print(f"[sv] {len(evidence)} evidence items → {len(calls)} calls")

    if warm_thread is not None:
        warm_thread.join()
        if warm_error:
            raise warm_error[0]
    depth: List[Optional[DepthProfile]] = [None] * len(samples)
    cnv_calls: List[list] = [[] for _ in samples]
    if cfg.annotate_depth and cfg.reference:
        with metrics.timer("sv.cnv"):
            depth = [DepthProfile.from_bam(s.full, cfg.reference,
                                           bin_size=cfg.cnv_bin_size,
                                           device=device)
                     if _local(si) else None
                     for si, s in enumerate(samples)]
            cnv_calls = [d.call_all() if d is not None else []
                         for d in depth]

    fmt_keys = ["GT", "SU", "PE", "SR"]
    if cfg.genotype:
        fmt_keys += ["GQ", "SQ", "GL", "DP", "RO", "AO", "RS", "AS", "RP", "AP", "AB"]
    if cfg.annotate_depth:
        fmt_keys.append("CN")

    header = build_sv_header(refs, [s.name for s in samples], cfg)

    # per-sample genotyping fan-out (the reference loops `svtyper` per
    # sample, bin/speedseq:1490-1505; -t parallelizes across samples)
    def _geno_sample(si: int) -> List[Optional[GenotypeResult]]:
        g = genotypers[si]
        if g is None:
            return [None] * len(calls)
        return g.genotype_all(calls)

    with metrics.timer("sv.svtyper"):
        if cfg.threads > 1 and len(samples) > 1:
            with ThreadPoolExecutor(max_workers=cfg.threads) as pool:
                grs_all = list(pool.map(_geno_sample, range(len(samples))))
        else:
            grs_all = [_geno_sample(si) for si in range(len(samples))]

    # per-sample CN arrays (NaN = no CN for this call)
    cn_arr: List[Optional[np.ndarray]] = [None] * len(samples)
    for si, d in enumerate(depth):
        if d is None:
            continue
        cn_arr[si] = np.array([
            (d.genotype(ref_names[c.tid1], c.pos1, max(c.pos2, c.pos1 + 1))
             if c.svtype != BND else np.nan)
            for c in calls
        ], np.float64)

    # read-depth side outputs (bin/speedseq:1550-1551), written by the
    # process that owns the sample
    if cfg.annotate_depth:
        base = output[:-7] if output.endswith(".vcf.gz") else output
        for s, d, cc in zip(samples, depth, cnv_calls):
            if d is not None:
                d.write_calls_txt(f"{base}.{s.name}.readdepth.txt", cc)
                d.write_calls_bed(f"{base}.{s.name}.readdepth.bed", cc)

    if _shard is not None and _exchange is not None:
        t_local = time.time() - t_start
        grs_all, cn_arr = _exchange_sample_results(
            _exchange, grs_all, cn_arr, len(calls), len(samples), _local,
            cfg.genotype)
        print(f"[sv-mh] p{pid_}: local {t_local:.2f}s exchange "
              f"{time.time() - t_start - t_local:.2f}s", flush=True)
        if pid_ != 0:
            for g in genotypers:
                if g is not None:
                    g.close()
            return None

    with metrics.timer("sv.emit"):
        records: List[VCFRecord] = []
        for vid, call in enumerate(calls, start=1):
            grs = [grs_all[si][vid - 1] for si in range(len(samples))]
            cns = [
                (float(cn_arr[si][vid - 1])
                 if cn_arr[si] is not None
                 and not np.isnan(cn_arr[si][vid - 1]) else None)
                for si in range(len(samples))
            ]
            sample_cols = [
                _sample_format(grs[si], call, si, cns[si])
                for si in range(len(samples))
            ]
            if call.svtype == BND:
                records.extend(
                    _bnd_records(call, vid, ref_names, sample_cols, fmt_keys,
                                 cfg))
                continue
            info: Dict[str, object] = {"SVTYPE": call.svtype}
            svlen = call.pos2 - call.pos1
            info["SVLEN"] = -svlen if call.svtype == DEL else svlen
            # breakend convention: pos1 = first affected base (0-based),
            # pos2 = first base after the event; VCF: DEL anchors at the
            # base before, END (1-based) = last affected base = pos2 in
            # 0-based numbering
            info["END"] = call.pos2
            info["STRANDS"] = _strands_str(call)
            if call.imprecise:
                info["IMPRECISE"] = True
            info["CIPOS"] = list(call.cipos)
            info["CIEND"] = list(call.ciend)
            info["CIPOS95"] = list(call.cipos95)
            info["CIEND95"] = list(call.ciend95)
            info["SU"] = call.su
            info["PE"] = call.pe
            info["SR"] = call.sr
            if cfg.prob_curves:
                info["PRPOS"] = _prob_str(call.prpos)
                info["PREND"] = _prob_str(call.prend)
            rec_pos = call.pos1 - 1 if call.svtype == DEL else call.pos1
            records.append(
                VCFRecord(
                    chrom=ref_names[call.tid1], pos=rec_pos, id=str(vid),
                    ref="N", alt=[f"<{call.svtype}>"], qual=None, filter=".",
                    info=info, format=fmt_keys, samples=sample_cols,
                )
            )
        for g in genotypers:
            if g is not None:
                g.close()

        order = {n: i for i, n in enumerate(ref_names)}
        records.sort(key=lambda r: (order.get(r.chrom, 1 << 30), r.pos))
        with VCFWriter(output, header) as w:
            for r in records:
                w.write(r)
        if output.endswith(".gz"):
            tabix_mod.build_tbi(output)
    return output


# --------------------------------------------------------------------------
# multi-process per-sample result exchange (parallel.multihost.sv_multihost)
# --------------------------------------------------------------------------

_GT_CODE = {"0/0": 0.0, "0/1": 1.0, "1/1": 2.0, "./.": 3.0}
_CODE_GT = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}
_GR_W = 14       # packed GenotypeResult width


def _pack_grs(grs: List[Optional[GenotypeResult]]) -> np.ndarray:
    """GenotypeResults → (C, 14) f64 rows (NaN col 0 = None)."""
    out = np.full((len(grs), _GR_W), np.nan)
    for i, gr in enumerate(grs):
        if gr is None:
            continue
        gl = list(gr.gl[:3]) + [0.0] * (3 - len(gr.gl[:3]))
        out[i] = [_GT_CODE.get(gr.gt, 3.0), gr.gq, gr.sq, *gl,
                  gr.dp, gr.ro, gr.ao, gr.rs, gr.as_, gr.rp, gr.ap, gr.ab]
    return out


def _unpack_grs(arr: np.ndarray) -> List[Optional[GenotypeResult]]:
    out: List[Optional[GenotypeResult]] = []
    for row in arr:
        if np.isnan(row[0]):
            out.append(None)
            continue
        out.append(GenotypeResult(
            gt=_CODE_GT[int(row[0])], gq=int(row[1]), sq=float(row[2]),
            gl=[float(x) for x in row[3:6]], dp=int(row[6]),
            ro=int(row[7]), ao=int(row[8]), rs=int(row[9]),
            as_=int(row[10]), rp=int(row[11]), ap=int(row[12]),
            ab=float(row[13])))
    return out


def _exchange_sample_results(exchange, grs_all, cn_arr, n_calls: int,
                             n_samples: int, is_local, genotyped: bool):
    """Allgather per-sample genotype/CN matrices so every process holds
    every sample's results (fixed-width f64 payloads over the same
    transport the align/var exchanges use)."""
    parts = []
    for si in range(n_samples):
        if not is_local(si):
            continue
        g = (_pack_grs(grs_all[si]) if genotyped
             else np.zeros((0, _GR_W)))
        c = cn_arr[si] if cn_arr[si] is not None else np.zeros(0)
        parts.append(struct.pack("<qqq", si, g.shape[0], len(c))
                     + g.tobytes() + np.asarray(c, np.float64).tobytes())
    payload = struct.pack("<q", len(parts)) + b"".join(parts)
    peers = exchange.allgather(2 ** 20, payload)
    for pl in peers:
        (nloc,) = struct.unpack_from("<q", pl, 0)
        off = 8
        for _ in range(nloc):
            si, gC, cC = struct.unpack_from("<qqq", pl, off)
            off += 24
            if gC:
                g = np.frombuffer(
                    pl, np.float64, gC * _GR_W, off).reshape(gC, _GR_W)
                off += gC * _GR_W * 8
                grs_all[si] = _unpack_grs(g)
            if cC:
                cn_arr[si] = np.frombuffer(pl, np.float64, cC, off).copy()
                off += cC * 8
    return grs_all, cn_arr


def _bnd_records(call, vid, ref_names, sample_cols, fmt_keys, cfg):
    """Paired BND records (VCF spec bracket notation, lumpy style)."""
    c1, p1 = ref_names[call.tid1], call.pos1
    c2, p2 = ref_names[call.tid2], call.pos2
    # orientation: strand 0 (+) = junction extends right of pos
    def alt_of(chrom, pos, this_strand, other_strand):
        m = f"{chrom}:{pos + 1}"
        if this_strand == 0 and other_strand == 1:
            return f"N[{m}["
        if this_strand == 0 and other_strand == 0:
            return f"N]{m}]"
        if this_strand == 1 and other_strand == 1:
            return f"[{m}[N"
        return f"]{m}]N"

    base_info = {
        "SVTYPE": "BND",
        "STRANDS": _strands_str(call),
        "SU": call.su,
        "PE": call.pe,
        "SR": call.sr,
    }
    if call.imprecise:
        base_info["IMPRECISE"] = True
    recs = []
    for which, (chrom, pos, alt) in enumerate(
        [
            (c1, p1, alt_of(c2, p2, call.strand1, call.strand2)),
            (c2, p2, alt_of(c1, p1, call.strand2, call.strand1)),
        ]
    ):
        info = dict(base_info)
        info["MATEID"] = f"{vid}_{2 - which}"
        info["EVENT"] = str(vid)
        info["CIPOS"] = list(call.cipos if which == 0 else call.ciend)
        info["CIEND"] = list(call.ciend if which == 0 else call.cipos)
        if cfg.prob_curves:
            info["PRPOS"] = _prob_str(call.prpos if which == 0 else call.prend)
            info["PREND"] = _prob_str(call.prend if which == 0 else call.prpos)
        recs.append(
            VCFRecord(
                chrom=chrom, pos=pos, id=f"{vid}_{which + 1}", ref="N",
                alt=[alt], qual=None, filter=".", info=info,
                format=fmt_keys, samples=sample_cols,
            )
        )
    return recs
