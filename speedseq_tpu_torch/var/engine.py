"""speedseq var equivalent: BAMs → filtered, sorted, bgzipped VCF + tabix.

Reference contract (bin/speedseq:506-833):
- windows from ``-w`` BED else one per chromosome from the BAM header @SQ
  (:677-687), scheduled most-expensive-first (README.md:153-155)
- per-window freebayes with ``--min-repeat-entropy 1`` (:704-710)
- per-window vawk filter ``$6>=MINQUAL && I$RPR>0 && I$RPL>0`` with
  MINQUAL default 1 (:709; default :544) — evaluated through the same
  vawk-expression compiler (formats/vcf_filter.py)
- windows fanned out over ``-t`` workers (``parallel -j $THREADS``,
  :719) — here a thread pool with per-thread BAM readers
- windows merged by coordinate sort, header from first window, bgzip,
  tabix (:722-806, :815)
Multi-sample: one VCF column per distinct SM read group across the input
BAMs (README.md:250-253).

Device work (the haplotype scan inside each window's host phase, and one
genotyping program over all windows' sites) runs on the run's device:
cuda unless the caller asks for cpu.  A host-side window failure is
contained as the reference's ``|| true`` contains it; a failure of a
device call fails the run.
"""

from __future__ import annotations

import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..formats import bai as bai_mod
from ..formats import tabix as tabix_mod
from ..formats.bam import BAMReader
from ..formats.bed import BedInterval, longest_first, read_bed, windows_from_refs
from ..formats.fasta import FastaFile
from ..formats.vcf import VCFHeader, VCFWriter
from ..formats.vcf_filter import compile_filter
from .caller import CallerConfig, DeviceError, site_to_vcf
from .pileup import build_pileup_columns

# Windows are genotyped in batches of about this many compacted (site,
# read) cells (a batch closes with the window that crosses it): one device
# program per batch instead of one per window, and the program's memory
# bounded by the batch, not by the run.  Prepared windows wait for their
# batch only while genotyping keeps up with the window phase.
GENOTYPE_BATCH_CELLS = 1 << 22


@dataclass
class VarConfig:
    min_qual: float = 1.0           # speedseq var -q default (MINQUAL=1)
    window_size: int = 100_000      # internal chunking of chromosome windows
    caller: CallerConfig = field(default_factory=CallerConfig)
    apply_balance_filter: bool = True  # the RPR>0 && RPL>0 vawk filter
    threads: int = 1                # speedseq -t (parallel -j, bin/speedseq:719)
    verbose: bool = False


def _sample_map(readers: List[BAMReader], paths: List[str]):
    """sample name per (bam_idx, RG id); VCF columns in first-seen order
    (freebayes SM semantics, README.md:250-253)."""
    samples: List[str] = []
    rg_to_sample: Dict[Tuple[int, str], int] = {}
    default_sample: Dict[int, int] = {}
    for bi, rd in enumerate(readers):
        found = False
        for line in rd.header.text.splitlines():
            if line.startswith("@RG"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                sm = fields.get("SM", os.path.basename(paths[bi]))
                if sm not in samples:
                    samples.append(sm)
                rg_to_sample[(bi, fields.get("ID", ""))] = samples.index(sm)
                found = True
        if not found:
            sm = os.path.basename(paths[bi])
            if sm not in samples:
                samples.append(sm)
            default_sample[bi] = samples.index(sm)
    return samples, rg_to_sample, default_sample


def _fetch_window_raw(
    rd: BAMReader, idx, tid: int, start: int, end: int
) -> bytes:
    """Region fetch as raw record bytes (block_size-prefixed, the native
    bam_decode input) — bulk chunk reads, no SAMRecord objects; tid and
    overlap filters happen columnarly in build_pileup_columns."""
    return bai_mod.fetch_raw(rd, idx, tid, start, end)


def _concat_cols(parts):
    """Concatenate decoded BamColumns batches (offsets rebased)."""
    if len(parts) == 1:
        return parts[0]
    kw = {}
    for f in ("tid", "pos", "ref_end", "mapq", "flag", "mtid", "mpos",
              "tlen"):
        kw[f] = np.concatenate([getattr(c, f) for c in parts])
    for bf, of in (
        ("qname_blob", "qname_off"), ("cigar_blob", "cigar_off"),
        ("seq_blob", "seq_off"), ("aux_blob", "aux_off"),
    ):
        offs, base = [], 0
        for c in parts:
            o = getattr(c, of)
            offs.append(o[:-1] + base)
            base += int(o[-1])
        offs.append(np.asarray([base], np.int64))
        kw[of] = np.concatenate(offs)
        kw[bf] = np.concatenate(
            [getattr(c, bf)[: int(getattr(c, of)[-1])] for c in parts])
    kw["qual_blob"] = np.concatenate(
        [c.qual_blob[: int(c.seq_off[-1])] for c in parts])
    return native.BamColumns(**kw)


def _columnar_sample_ids(
    cols, bi: int, rg_map: Dict[Tuple[int, str], int],
    default_map: Dict[int, int],
) -> np.ndarray:
    """Sample index per decoded record.  When every RG of this BAM maps to
    one sample (the overwhelmingly common case) this is a constant fill;
    otherwise the aux blobs are walked for RG:Z tags (rare)."""
    bam_samples = {v for (b, _), v in rg_map.items() if b == bi}
    if not bam_samples:
        return np.full(cols.n, default_map.get(bi, 0), np.int32)
    if len(bam_samples) == 1:
        return np.full(cols.n, next(iter(bam_samples)), np.int32)
    # multi-sample BAM: vectorized distinct-RG:Z lookup (shared helper,
    # sv/columnar.unique_ztag_values — no per-record aux walk)
    from ..sv.columnar import unique_ztag_values

    out = np.full(cols.n, default_map.get(bi, 0), np.int32)
    rows, uniqs, inv = unique_ztag_values(cols, "RG")
    if len(rows):
        ids = np.array([
            rg_map.get((bi, u), default_map.get(bi, 0)) for u in uniqs],
            np.int32)
        out[rows] = ids[inv]
    return out


def build_var_header(
    contigs: List[Tuple[str, int]], samples: List[str], somatic: bool = False
) -> VCFHeader:
    h = VCFHeader.build(contigs, samples, source="speedseq_tpu_torch-var")
    h.add_info("DP", "1", "Integer", "Total read depth at the locus")
    h.add_info("RO", "1", "Integer", "Reference allele observation count")
    h.add_info("AO", "A", "Integer", "Alternate allele observation count")
    h.add_info("AB", "A", "Float", "Allele balance at heterozygous sites")
    h.add_info("RPL", "A", "Integer",
               "Reads Placed Left: reads supporting the alternate balanced to the left")
    h.add_info("RPR", "A", "Integer",
               "Reads Placed Right: reads supporting the alternate balanced to the right")
    h.add_info("SAF", "A", "Integer", "Alternate allele observations on the forward strand")
    h.add_info("SAR", "A", "Integer", "Alternate allele observations on the reverse strand")
    h.add_info("TYPE", "A", "String", "The type of allele: snp, mnp, ins, del or complex")
    h.add_info("LEN", "A", "Integer", "Allele length")
    h.add_info("NUMALT", "1", "Integer", "Number of alternate alleles")
    if somatic:
        h.add_info("SSC", "1", "Float", "Somatic score")  # bin/speedseq:1087
    h.add_format("GT", "1", "String", "Genotype")
    h.add_format("GQ", "1", "Integer", "Genotype quality")
    h.add_format("DP", "1", "Integer", "Read depth")
    h.add_format("RO", "1", "Integer", "Reference allele observation count")
    h.add_format("QR", "1", "Integer", "Sum of quality of reference observations")
    h.add_format("AO", "A", "Integer", "Alternate allele observation count")
    h.add_format("QA", "A", "Integer", "Sum of quality of alternate observations")
    h.add_format("GL", "G", "Float", "Genotype log10 likelihoods")
    return h


def run_var(
    reference: str,
    bam_paths: List[str],
    output: str,                      # *.vcf.gz
    windows_bed: Optional[str] = None,
    config: VarConfig = VarConfig(),
    record_filter=None,
    _somatic_header: bool = False,
    device=None,
    _shard: Optional[Tuple[int, int]] = None,
    _part_out: Optional[str] = None,
) -> str:
    """Run variant calling on ``device`` (cuda unless the caller asks for
    cpu); returns the output path.  On ``cuda`` (no card index) with
    several cards visible, the genotyping program's site axis is sharded
    over all of them (a parallel.mesh.Mesh; the records do not change).

    ``record_filter(rec) -> Optional[VCFRecord]`` post-processes the
    records that pass the vawk filter (somatic mode injects the SSC
    filter here); ``_somatic_header`` declares ``##INFO SSC``.

    ``_shard=(P, pid)`` restricts this process to the windows with index
    ``wi % P == pid`` (round-robin over the longest-first order: the
    multi-process counterpart of the reference's window fan-out,
    bin/speedseq:719); ``_part_out`` then writes the sorted records as a
    raw-byte part stream instead of the VCF (parallel.multihost merges
    the parts)."""
    cfg = config
    device = resolve_device(device)
    mesh = None
    if (device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 1):
        from ..parallel.mesh import make_mesh

        mesh = make_mesh()
    fa = FastaFile(reference)
    with BAMReader(bam_paths[0]) as rd0:
        refs = rd0.header.refs
    readers0 = [BAMReader(p) for p in bam_paths]
    indexes = []
    for p in bam_paths:
        if not os.path.exists(p + ".bai"):
            bai_mod.build_bai(p)
        indexes.append(bai_mod.read_bai(p + ".bai"))
    samples, rg_map, default_map = _sample_map(readers0, bam_paths)
    for rd in readers0:
        rd.close()

    # the reference's per-window vawk filter (bin/speedseq:709), compiled
    # by the vawk-expression engine
    expr = f"$6>={cfg.min_qual!r}"
    if cfg.apply_balance_filter:
        expr += " && I$RPR>0 && I$RPL>0"
    vawk_filter = compile_filter(expr)

    # windows: BED or per-chromosome (bin/speedseq:677-687), internally
    # chunked, scheduled longest-first (README.md:153-155)
    if windows_bed:
        windows = read_bed(windows_bed)
    else:
        windows = windows_from_refs(refs, window=cfg.window_size)
    windows = longest_first(windows)

    ref_names = [n for n, _ in refs]
    genome_cache: Dict[str, np.ndarray] = {}
    cache_lock = threading.Lock()
    tls = threading.local()
    all_readers: List[List[BAMReader]] = []
    all_readers_lock = threading.Lock()

    def _readers() -> List[BAMReader]:
        if not hasattr(tls, "readers"):
            tls.readers = [BAMReader(p) for p in bam_paths]
            with all_readers_lock:
                all_readers.append(tls.readers)
        return tls.readers

    def _genome(chrom: str) -> np.ndarray:
        with cache_lock:
            if chrom not in genome_cache:
                genome_cache[chrom] = fa.fetch_encoded(chrom)
            return genome_cache[chrom]

    # raw bytes → native decode → vectorized pileup.  A window's host
    # failure is contained below, so the runtime loads here: without it
    # the run fails instead of calling every window empty
    native.load()

    from .caller import finish_window, genotype_windows, prepare_window
    from ..utils.metrics import metrics

    def _pileup(w: BedInterval):
        """The window's reads (all BAMs) as a pileup; None without reads."""
        tid = ref_names.index(w.chrom)
        parts, sids = [], []
        for bi, rd in enumerate(_readers()):
            with metrics.timer("var.fetch"):
                blob = _fetch_window_raw(rd, indexes[bi], tid, w.start,
                                         w.end)
            if not blob:
                continue
            metrics.add("var.fetch_bytes", len(blob))
            with metrics.timer("var.decode"):
                c = native.bam_decode(blob)
                parts.append(c)
                sids.append(_columnar_sample_ids(c, bi, rg_map,
                                                 default_map))
        if not parts:
            return None
        with metrics.timer("var.columns"):
            return build_pileup_columns(
                _concat_cols(parts), np.concatenate(sids), w.start,
                w.end, min_mapq=cfg.caller.min_mapq,
                min_baseq=cfg.caller.min_baseq, tid=tid,
            )

    def _prep_window(item: Tuple[int, BedInterval]):
        """Window phase: fetch + pileup (timer var.pileup), then loci with
        the haplotype scan on the device and compaction (var.loci);
        genotyping comes later, batched."""
        wi, w = item
        if w.chrom not in ref_names:
            return wi, w, None
        with metrics.timer("var.pileup"):
            pile = _pileup(w)
        if pile is None:
            return wi, w, None
        metrics.add("var.windows")
        metrics.add("var.reads", len(pile.rstart))
        with metrics.timer("var.loci"):
            return wi, w, prepare_window(_genome(w.chrom), pile, len(samples),
                                         cfg.caller, device)

    def _prep_safe(item):
        """Window-failure tolerance: the reference merges windows with
        ``|| true`` so one empty/failed window never aborts the run
        (bin/speedseq:768,803).  A window whose host phase fails logs and
        yields no records; the merge proceeds.  A device failure
        (DeviceError) is not contained: it fails the run."""
        try:
            return _prep_window(item)
        except DeviceError:
            raise
        except Exception as e:  # noqa: BLE001 — deliberate containment
            import traceback

            wi, w = item
            metrics.add("var.windows_failed")
            print(f"[var] window {w.chrom}:{w.start}-{w.end} failed: "
                  f"{type(e).__name__}: {e}", flush=True)
            if cfg.verbose:
                traceback.print_exc()
            return wi, w, None

    def _emit(wi, w, pw, g):
        if pw is None or g is None:
            return wi, []
        calls = finish_window(pw, g, cfg.caller)
        metrics.add("var.sites", len(calls))
        out = []
        for c in calls:
            rec = site_to_vcf(c, w.chrom, w.start, len(samples))
            if not vawk_filter(rec):
                continue
            if record_filter is not None:
                rec = record_filter(rec)
                if rec is None:
                    continue
            out.append(rec)
        if cfg.verbose:
            print(f"[var] {w.chrom}:{w.start}-{w.end}: {len(calls)} sites")
        return wi, out

    items = list(enumerate(windows))
    if _shard is not None:
        P_, pid_ = _shard
        items = [it for it in items if it[0] % P_ == pid_]
    results = []

    def _genotype_and_emit(batch):
        with metrics.timer("var.genotype"):
            gs = genotype_windows([pw for _, _, pw in batch], len(samples),
                                  cfg.caller, device=device, mesh=mesh)
        with metrics.timer("var.emit"):
            results.extend(_emit(wi, w, pw, g)
                           for (wi, w, pw), g in zip(batch, gs))
        batch.clear()

    pool = ThreadPoolExecutor(cfg.threads) if cfg.threads > 1 else None
    try:
        prepped = (pool.map(_prep_safe, items) if pool is not None
                   else map(_prep_safe, items))
        batch, cells = [], 0
        for wi, w, pw in prepped:
            batch.append((wi, w, pw))
            cells += 0 if pw is None else pw.obs.size
            if cells >= GENOTYPE_BATCH_CELLS:
                _genotype_and_emit(batch)
                cells = 0
        _genotype_and_emit(batch)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        for rds in all_readers:
            for rd in rds:
                rd.close()
    if cfg.verbose:
        print(metrics.report(prefix="[var] "))

    # deterministic merge: coordinate sort, window order as tiebreak
    # (bin/speedseq:800-806)
    order = {n: i for i, n in enumerate(ref_names)}
    tagged = [
        (order.get(r.chrom, 1 << 30), r.pos, wi, r)
        for wi, recs in results
        for r in recs
    ]
    tagged.sort(key=lambda t: t[:3])
    if _part_out is not None:
        # sorted raw-byte part stream of (order, pos, wi, len) + VCF line
        # entries: the multi-process merge heap-merges them without
        # parsing a record (the reference concatenates window files and
        # sorts, bin/speedseq:800-806)
        tmp = _part_out + ".tmp"
        with open(tmp, "wb") as fh:
            for order_, pos_, wi_, r in tagged:
                line = (r.to_line() + "\n").encode()
                fh.write(struct.pack("<qqqI", order_, pos_, wi_, len(line)))
                fh.write(line)
        os.replace(tmp, _part_out)
        return _part_out
    # somatic mode declares ##INFO SSC (the reference injects it into
    # the merged header, bin/speedseq:1087)
    header = build_var_header(refs, samples, somatic=_somatic_header)
    with VCFWriter(output, header) as w_:
        for _, _, _, r in tagged:
            w_.write(r)
    if output.endswith(".gz"):
        tabix_mod.build_tbi(output)  # bin/speedseq:815
    return output
