"""speedseq align equivalent on PyTorch/CUDA: FASTQ → sorted BAM +
splitters + discordants.

Counterpart of speedseq_tpu/align/pipeline.py (single device).  The device
step is core.fused_align_leaves (hash or FM seeding, both banded SW
kernels); the host epilogue
(MAPQ, streaming dup marking, splitter/discordant extraction, external
coordinate sort, BAM + BAI) is the JAX package's, copied.

Three stages overlap: the main thread dispatches batch i+1's device step
(CUDA launches return at once) while a 1-thread fetch pool waits on batch
i's CUDA event (its device-to-host copy into pinned host memory) and a
1-thread drain pool runs the ordered host epilogue.

The main thread's time is split into spans (``utils/metrics.py``):
``align.index_load`` (``.read``, ``.kmer``, ``.to_device``),
``align.input_wait`` (blocked on the FASTQ prefetch), ``align.dispatch``
(the step's launches; inside it the stages ``align.stage.<s>``),
``align.drain_wait`` (blocked on the epilogue's look-ahead) and
``align.close`` (the sorters' merge, BGZF writes and BAIs after the last
batch).  On cuda each step's stream span is ``align.device_step_s`` and
each stage's ``align.stage.<s>.stream_s``, from CUDA events read once
the batch's fetch has completed.

With a mesh (``device=`` a parallel.mesh.Mesh, or on ``cuda`` when more
than one card is visible and divides the batch), each batch's step runs
sharded over the mesh (parallel.mesh.distributed_fused_step); the records
do not change.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..formats import bai, fastq
from ..formats.sam import (
    FDUP, FMREVERSE, FMUNMAP, FPAIRED, FPROPER_PAIR, FREAD1, FREAD2,
    FREVERSE, FSUPPLEMENTARY, FUNMAP, SAMHeader, SAMRecord, cigar_to_str,
)
from ..index.bwt import BWAIndex, build_index, load_index
from ..index.fm import FMIndex, _reconstruct_sa
from ..index.kmer import kmer_arrays_np, kmer_index_from_arrays
from ..utils.metrics import metrics
from ..utils.prefetch import prefetch
from .core import (DEFAULT_DISTRO, HostAlignment, _orig_frame,
                   device_estimate_distro, fused_align_leaves, pack_leaves,
                   stage_marks, unpack_fused, unpack_leaves, unpack_xa)
from .markdup import (StreamDupMarker, make_sa_tag, split_qualifies,
                      strip_seq, unclipped_5p)
from .pairing import InsertDistro, is_proper

PG_LINE = "@PG\tID:speedseq_tpu_torch\tPN:speedseq_tpu_torch\tVN:0.1.0"


@dataclass
class AlignConfig:
    batch_size: int = 512
    max_read_len: int = 151
    n_chains: int = 4
    min_seed_len: int = 19
    rg_id: str = "1"
    sample: str = "sample"
    rg_string: Optional[str] = None   # full @RG line override (bwa -R / -R)
    include_dups_in_side: bool = False  # speedseq -i (bin/speedseq:267-269)
    max_split_count: int = 2          # samblaster -c (bin/speedseq:242)
    min_non_overlap: int = 20         # samblaster -m (bin/speedseq:243)
    insert_override: Optional[Tuple[float, float, int, int]] = None
    # bwa -I mean,std,max,min (bin/speedseq:438; README.md:203-207)
    checkpoint: bool = False   # per-batch checkpoint journal
    resume: bool = False
    checkpoint_every: int = 8
    seed_mode: str = "hash"    # "hash" (k-mer index) | "fm" (SMEM search)
    sort_max_records: int = 200_000  # external-sort chunk size
    distro_update_every: int = 32    # batches between insert-distro
    # re-estimates (bwa re-estimates per chunk; README.md:203-207)
    verbose: bool = False

    def __post_init__(self):
        if self.rg_string:
            d = dict(
                f.split(":", 1)
                for f in self.rg_string.replace("\\t", "\t").split("\t")[1:]
                if ":" in f
            )
            self.rg_id = d.get("ID", self.rg_id)
            self.sample = d.get("SM", self.sample)


_host_cache: Dict[Tuple[str, str], tuple] = {}


def _sa_cache_path(reference: str) -> str:
    """On-disk cache of the full suffix array, keyed by the reference
    file's path, mtime and size."""
    import hashlib

    st = os.stat(reference)
    key = hashlib.sha1(
        f"{os.path.abspath(reference)}:{st.st_mtime_ns}:{st.st_size}"
        .encode()).hexdigest()[:16]
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "speedseq_tpu_torch", f"safull-{key}.npy")


def _full_sa(reference: str, idx) -> np.ndarray:
    """The full SA of ``idx`` from the disk cache, else reconstructed from
    the index (and cached; a failed write only costs the next run)."""
    path = _sa_cache_path(reference)
    if os.path.exists(path):
        try:
            sa = np.load(path)
            if sa.shape == (idx.seq_len + 1,):
                return sa
        except (OSError, ValueError):
            pass
    sa = _reconstruct_sa(idx).astype(np.int32)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as fh:
            np.save(fh, sa)
        os.replace(tmp, path)
    except OSError:
        pass
    return sa


def _load_fm(reference: str, device: torch.device, seed_mode: str = "hash"):
    """(BWAIndex, FMIndex, KmerIndex or None) for ``reference`` on
    ``device``: loads the bwa index files if present, else builds them (the
    auto `bwa index` behaviour, bin/speedseq:386-391).  The hash path adds
    the k-mer index and reads no suffix array; the FM path adds the FMD
    arrays and the full SA (cached on disk).  The host arrays are cached per
    process (one reference and mode at a time); the device tensors are made
    per call."""
    key = (os.path.abspath(reference), seed_mode)
    mtime = os.stat(reference).st_mtime_ns
    hit = _host_cache.get(key)
    if hit is None or hit[0] != mtime:
        with metrics.timer("align.index_load.read"):
            if not os.path.exists(reference + ".bwt"):
                idx = build_index(reference)
            else:
                idx = load_index(reference)
            if seed_mode == "fm":
                host = _full_sa(reference, idx)   # read from its disk cache
        if seed_mode != "fm":
            with metrics.timer("align.index_load.kmer"):
                host = kmer_arrays_np(idx.pac)
        hit = (mtime, idx, host)
        _host_cache.clear()
        _host_cache[key] = hit
    _, idx, host = hit
    with metrics.timer("align.index_load.to_device"):
        if seed_mode == "fm":
            return idx, FMIndex.from_bwa_fm(idx, host, device), None
        starts, positions, fp, bits = host
        kidx = kmer_index_from_arrays(starts, positions, fp, len(idx.pac),
                                      19, bits, device)
        return idx, FMIndex.from_bwa(idx, device), kidx


def align_fastq(
    reference: str,
    fq1: str,
    fq2: Optional[str] = None,
    interleaved: bool = False,
    out_prefix: str = "out",
    config: AlignConfig = AlignConfig(),
    device=None,
) -> Dict[str, str]:
    """Run the full align module on FASTQ input; returns output paths.
    Runs on ``cuda`` unless ``device="cpu"``."""
    cfg = config
    batches = fastq.iter_batches(
        fq1, batch_size=cfg.batch_size, max_len=cfg.max_read_len,
        paired_with=fq2, interleaved=interleaved,
    )
    paired = fq2 is not None or interleaved
    return align_stream(reference, batches, out_prefix, cfg, paired=paired,
                        device=device)


class _EventPool:
    """Timing CUDA events for reuse across batches: a batch's events go
    back once its drain has read them."""

    def __init__(self):
        self._free: List[torch.cuda.Event] = []
        self._lock = threading.Lock()

    def take(self) -> "torch.cuda.Event":
        with self._lock:
            if self._free:
                return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    def give(self, events) -> None:
        with self._lock:
            self._free.extend(events)


def _fetch(tensors, device: torch.device):
    """Start the device-to-host copies of ``tensors``; returns a callable
    that waits for them (on a CUDA event) and yields numpy arrays."""
    if device.type != "cuda":
        host = [t.numpy() for t in tensors]
        return lambda: host
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()

    def wait():
        ev.synchronize()
        return [h.numpy() for h in host]

    return wait


def _run_mesh(device, batch_size: int):
    """(mesh or None, the run's device): the mesh given as ``device``
    (its size must divide the batch), or on ``cuda`` (no card index)
    every visible card when there are several and they divide the
    batch."""
    from ..parallel.mesh import Mesh, make_mesh

    if isinstance(device, Mesh):
        if batch_size % device.size:
            raise ValueError(f"batch size {batch_size} is not a multiple "
                             f"of the mesh size {device.size}")
        return (device if device.size > 1 else None), device.devices[0]
    dev = resolve_device(device)
    n = torch.cuda.device_count()
    if dev.type == "cuda" and dev.index is None and n > 1 \
            and batch_size % n == 0:
        return make_mesh(), dev
    return None, dev


def align_stream(
    reference: str,
    batch_iter,
    out_prefix: str,
    config: AlignConfig = AlignConfig(),
    rg_lines: Optional[List[str]] = None,
    paired: bool = True,
    marker: Optional[StreamDupMarker] = None,
    device=None,
    sorter_factory=None,
    pre_close=None,
) -> Dict[str, str]:
    """Align a stream of (ReadBatch, ReadBatch|None) pairs.

    ReadBatch.comments entries of the form ``RG:<id>`` carry per-read read
    groups; otherwise cfg.rg_id applies.  Runs on ``cuda`` unless
    ``device="cpu"``; raises when CUDA is asked for and absent.
    ``device`` may also be a parallel.mesh.Mesh: each batch's step then
    runs sharded over it (the batch size a multiple of the mesh size).

    ``sorter_factory(key, path, header) -> sorter`` replaces the default
    ExternalBAMSorter per output stream (the multi-process coordinate
    re-shard injects parallel.multihost.ReshardingSorter here); such
    sorters are closed one after another in a fixed stream order, so the
    exchanges they make while closing pair up across processes.
    ``pre_close()`` runs after the last batch, before the sorters close
    (the multi-process dup marker pads its exchange waves there)."""
    t0 = time.time()
    cfg = config
    mesh, dev = _run_mesh(device, cfg.batch_size)
    if cfg.seed_mode not in ("hash", "fm"):
        raise ValueError(f"unknown seed_mode {cfg.seed_mode!r}")
    with metrics.timer("align.index_load"):
        idx, fm, kidx = _load_fm(reference, dev, cfg.seed_mode)

    distro: Optional[InsertDistro] = None
    if cfg.insert_override is not None:
        m, s, mx, mn = cfg.insert_override
        distro = InsertDistro(mean=m, std=s, low=int(mn), high=int(mx))
    n_reads = 0

    header = SAMHeader.build(
        refs=list(zip(idx.names, idx.lengths)),
        read_groups=rg_lines if rg_lines else [_rg_line(cfg)],
        sort_order="coordinate",
        programs=[PG_LINE],
    )
    from ..formats.extsort import ExternalBAMSorter

    mk = sorter_factory or (lambda key, path, hdr: ExternalBAMSorter(
        path, hdr, max_records=cfg.sort_max_records))
    sorters = {key: mk(key, out_prefix + suffix, header)
               for key, suffix in _OUTPUTS}
    # an injected marker carries dup state shared across processes
    # (parallel.multihost.WaveSyncDupMarker); the default is this run's
    if marker is None:
        marker = StreamDupMarker()
    lib_of_rg = _lib_map(rg_lines, cfg)

    # checkpoint/resume: an append-only journal of O(batch)-sized segments
    # (new dup signatures since the previous segment + sorter chunk lists)
    ckpt_path = out_prefix + ".align.ckpt"
    done_batches = 0
    if cfg.resume:
        segs = _read_journal(ckpt_path)
        agree = getattr(marker, "agree_resume", None)
        if agree is not None:
            # processes that share a dup table resume together, at the
            # last batch that every one of them checkpointed
            at = [g["batch"] for g in segs]
            target = agree(at)
            segs = segs[:at.index(target) + 1] if target else []
        if os.path.exists(ckpt_path):
            # the journal is cut back to the segments resumed from (a
            # torn tail segment would otherwise hide later appends)
            _write_journal(ckpt_path, segs)
        if segs:
            seg = segs[-1]
            done_batches = seg["batch"]
            n_reads = seg["n_reads"]
            distro = seg["distro"]
            marker.replay([p for g in segs for p in g["new_pairs"]],
                          [o for g in segs for o in g["new_orphans"]])
            marker.drain_new()
            for k in sorters:
                sorters[k].restore(seg["sorters"][k])
            if cfg.verbose:
                print(f"[align] resumed at batch {done_batches} "
                      f"({n_reads} reads)")

    def _save_ckpt(bi):
        for s in sorters.values():
            s.spill()
        new_p, new_o = marker.drain_new()
        seg = {
            "batch": bi + 1, "n_reads": n_reads, "distro": distro,
            "new_pairs": new_p, "new_orphans": new_o,
            "sorters": {k: s.state() for k, s in sorters.items()},
        }
        with open(ckpt_path, "ab") as fh:
            pickle.dump(seg, fh)

    distro_arr = None
    if distro is not None:
        distro_arr = torch.tensor(
            [distro.mean, distro.std, distro.low, distro.high],
            dtype=torch.float32, device=dev)

    fetch_pool = ThreadPoolExecutor(max_workers=1)
    # the step's and its stages' stream marks (one card, no mesh)
    events = (_EventPool() if mesh is None and dev.type == "cuda"
              else None)

    def _drain(item) -> None:
        """Consume one dispatched batch: wait for its fetch, then run the
        host epilogue (ordered: dup marking is first-seen)."""
        nonlocal distro, n_reads
        bi = item["bi"]
        batches = item["batches"]
        n = batches[0].n
        with metrics.timer("align.fetch_wait"):
            fetched = item["fut"].result()
        if item["step_ev"] is not None:
            # every mark completed before the fetch's own event
            ev0, ev1 = item["step_ev"]
            metrics.add("align.device_step_s", ev0.elapsed_time(ev1) / 1e3)
            marks = item["marks"]
            for st, sec in marks.seconds().items():
                metrics.add(f"align.stage.{st}.stream_s", sec)
            events.give(item["step_ev"] + tuple(marks.events))
        meta_h, xam_h, ovf_h, cig, xac_h = unpack_leaves(
            fetched[0], fetched[1])
        if ovf_h:
            # rare: some lane exceeded the cigar head slice
            cig = item["cigfull"].cpu().numpy()
        ends = unpack_fused(meta_h, cig)
        xas = unpack_xa(xam_h, xac_h)
        if item["est_distro"]:
            # estimated on the device from this batch's stats; the 4
            # floats come back only for the host epilogue + logging
            f = np.asarray(fetched[2], np.float64)
            distro = InsertDistro(mean=float(f[0]), std=float(f[1]),
                                  low=int(f[2]), high=int(f[3]))
            if cfg.verbose:
                print(f"[align] insert distro mean={distro.mean:.1f} "
                      f"std={distro.std:.1f} "
                      f"bounds=[{distro.low},{distro.high}]")
        batch_distro = distro or InsertDistro(
            mean=300.0, std=100.0, low=50, high=700)
        from .emit import build_batch_records

        with metrics.timer("align.emit"):
            cols = build_batch_records(
                ends, batches, idx, batch_distro, cfg, marker, lib_of_rg,
                xas=xas,
            )
        with metrics.timer("align.sort_intake"):
            for key, _ in _OUTPUTS:
                sorters[key].add_columns(cols[key])
        n_reads += n * len(batches)
        metrics.add("align.batches")
        metrics.add("align.reads", n * len(batches))
        for key, _ in _OUTPUTS:
            metrics.add(f"align.records.{key}", cols[key].n)
        metrics.add("align.duplicates",
                    int((np.asarray(cols["bam"].flag) & FDUP != 0).sum()))
        if cfg.checkpoint and (bi + 1) % cfg.checkpoint_every == 0:
            _save_ckpt(bi)

    drain_pool = ThreadPoolExecutor(max_workers=1)
    drain_futs: "deque" = deque()
    try:
        for bi, (b1, b2) in enumerate(metrics.timed(
                prefetch(batch_iter), "align.input_wait")):
            if bi < done_batches:
                continue
            batches = [b1] + ([b2] if b2 is not None else [])
            is_paired_batch = paired and b2 is not None
            with metrics.timer("align.dispatch"):
                seqs = [torch.from_numpy(_pad_batch(bb.seq, cfg.batch_size))
                        .to(dev, non_blocking=True) for bb in batches]
                lens = [torch.from_numpy(
                    _pad_batch(bb.length[:, None], cfg.batch_size)[:, 0]
                    .astype(np.int32)).to(dev, non_blocking=True)
                    for bb in batches]
                # insert distro: estimated from batch 0 and every
                # distro_update_every batches after (a fixed schedule, so
                # it does not depend on thread timing); -I pins it
                est_distro = (
                    is_paired_batch and cfg.insert_override is None
                    and bi % cfg.distro_update_every == 0
                )
                step_ev = marks = None
                if events is not None:
                    step_ev = (events.take(), events.take())
                    step_ev[0].record()
                step_args = (seqs[0], lens[0],
                             seqs[1] if is_paired_batch else None,
                             lens[1] if is_paired_batch else None)
                step_kw = dict(distro=distro_arr, n_chains=cfg.n_chains,
                               min_seed_len=cfg.min_seed_len, kidx=kidx)
                if mesh is not None:
                    # the same step sharded over the mesh; its gathered
                    # outputs pack into the same two leaves
                    from ..parallel.mesh import distributed_fused_step

                    (meta_d, cig16_d, cigfull_d, ovf_d, stats_d, xam_d,
                     xac_d, _) = distributed_fused_step(
                        mesh, fm, *step_args, **step_kw)
                    i32_d, i16_d = pack_leaves(meta_d, cig16_d, ovf_d,
                                               xam_d, xac_d)
                else:
                    take = events.take if events is not None else None
                    with stage_marks(take) as marks:
                        i32_d, i16_d, cigfull_d, stats_d = \
                            fused_align_leaves(fm, *step_args,
                                               paired=is_paired_batch,
                                               **step_kw)
                if step_ev is not None:
                    step_ev[1].record()
                if est_distro:
                    # chained on the device: the next batch's step takes
                    # this (4,) tensor as a plain input, no host round trip
                    fb = (distro_arr if distro_arr is not None
                          else torch.tensor(DEFAULT_DISTRO,
                                            dtype=torch.float32, device=dev))
                    distro_arr = device_estimate_distro(
                        stats_d, fb, qlen=cfg.max_read_len)
                wait = _fetch([i32_d, i16_d] + (
                    [distro_arr] if est_distro else []), dev)
            item = {
                "bi": bi, "batches": batches, "est_distro": est_distro,
                "cigfull": cigfull_d, "fut": fetch_pool.submit(wait),
                "step_ev": step_ev, "marks": marks,
            }
            drain_futs.append(drain_pool.submit(_drain, item))
            # bounded look-ahead: at most 2 batches of fetched arrays live
            if len(drain_futs) > 2:
                with metrics.timer("align.drain_wait"):
                    while len(drain_futs) > 2:
                        drain_futs.popleft().result()
        with metrics.timer("align.drain_wait"):
            while drain_futs:
                drain_futs.popleft().result()
    finally:
        # on an interrupting exception, still wait for already-submitted
        # drains (their checkpoint segments must land deterministically)
        while drain_futs:
            f = drain_futs.popleft()
            try:
                f.result()
            except Exception:
                pass
        drain_pool.shutdown(wait=True)
        fetch_pool.shutdown(wait=True)

    # finalize the 3 outputs concurrently (sorter merge + BGZF write + BAI
    # build each), as the reference co-schedules with `parallel -j 3`
    def _close_one(key_suffix):
        key, suffix = key_suffix
        sorters[key].close()
        path = out_prefix + suffix
        if not getattr(sorters[key], "skip_bai", False):
            bai.build_bai(path)
        return suffix[1:], path

    with metrics.timer("align.close"):
        if os.path.exists(ckpt_path):
            os.remove(ckpt_path)
        if pre_close is not None:
            # the multi-process dup marker pads its exchange waves before
            # any sorter closes: a process's close-time exchanges must not
            # pair with a peer still waiting in a marker wave
            pre_close()
        if sorter_factory is not None:
            # one after another, in stream order: factory sorters may
            # make exchanges while closing
            outputs = dict(map(_close_one, _OUTPUTS))
        else:
            with ThreadPoolExecutor(max_workers=3) as close_pool:
                outputs = dict(close_pool.map(_close_one, _OUTPUTS))
    if cfg.verbose:
        dt = time.time() - t0
        print(f"[align] {n_reads} reads in {dt:.1f}s "
              f"({n_reads / dt:.0f} reads/s)")
        print(metrics.report(prefix="[align] "))
    return outputs


_OUTPUTS = (
    ("bam", ".bam"),
    ("splitters", ".splitters.bam"),
    ("discordants", ".discordants.bam"),
)


def _read_journal(path: str) -> list:
    """The complete segments of a checkpoint journal (none if absent; a
    truncated tail segment is dropped)."""
    segs: list = []
    if not os.path.exists(path):
        return segs
    with open(path, "rb") as fh:
        while True:
            try:
                segs.append(pickle.load(fh))
            except (EOFError, pickle.UnpicklingError):
                return segs


def _write_journal(path: str, segs: list) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        for g in segs:
            pickle.dump(g, fh)
    os.replace(tmp, path)


def _rg_line(cfg: AlignConfig) -> str:
    if cfg.rg_string:
        return cfg.rg_string.replace("\\t", "\t")
    return f"@RG\tID:{cfg.rg_id}\tSM:{cfg.sample}"


def _pad_batch(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    if a.dtype == np.uint8 and a.ndim == 2:
        pad[:] = 4
    return np.concatenate([a, pad], axis=0)


def _lib_map(rg_lines: Optional[List[str]], cfg: AlignConfig) -> Dict[str, int]:
    """RG id → library index for duplicate-signature scoping.  RGs sharing
    an LB value share a library index."""
    libs: Dict[str, int] = {}
    out: Dict[str, int] = {"": 0, cfg.rg_id: 0}
    if not rg_lines:
        return out
    for line in rg_lines:
        d = dict(
            f.split(":", 1)
            for f in line.replace("\\t", "\t").split("\t")[1:]
            if ":" in f
        )
        rid = d.get("ID")
        if rid is None:
            continue
        lb = d.get("LB", rid)
        out[rid] = libs.setdefault(lb, len(libs))
    return out


# ------------------------------------------- per-record host assembly (scalar)
# The JAX package's scalar record builder, copied: the streaming path above
# builds records column-wise (align/emit.py); these take the unfused API's
# selections (core.select_alignments / finalize_alignments).

def _phred(q: np.ndarray, length: int) -> str:
    return "".join(chr(min(int(x), 93) + 33) for x in q[:length])


@dataclass
class _PairRow:
    """Host record of one read end (primary + optional supplementary).

    seq_rc/qual_r are the reverse-complemented/reversed forms, which the
    caller computes for a whole batch at once."""

    name: str
    seq: str
    qual: str
    seq_rc: str
    qual_r: str
    aln: HostAlignment
    supp: Optional[HostAlignment]
    tid: int
    rg: str = ""


def assemble_records(
    rows1: List[_PairRow],
    rows2: Optional[List[_PairRow]],
    idx: BWAIndex,
    distro: InsertDistro,
    cfg: AlignConfig,
    marker: Optional[StreamDupMarker] = None,
    lib_of_rg: Optional[Dict[str, int]] = None,
):
    """Build SAM records with pair flags, mate tags, dup marks, and the
    splitter/discordant side channels.

    Called once per batch on the streaming path: ``marker`` carries the
    run-wide duplicate signature tables across calls (samblaster's
    streaming hash table); a fresh marker is made when none is given
    (single-shot use).  ``lib_of_rg`` scopes dup signatures per library.
    """
    paired = rows2 is not None
    n = len(rows1)
    main: List[SAMRecord] = []
    splitters: List[SAMRecord] = []
    discordants: List[SAMRecord] = []
    if marker is None:
        marker = StreamDupMarker()

    # offsets convert genome pos → (tid, chrom pos)
    offsets = np.asarray(idx.offsets + [idx.l_pac], dtype=np.int64)

    # ---- duplicate marking over pairs ----------------------------------
    lib = np.zeros(n, dtype=np.int64)
    if lib_of_rg:
        for i, r in enumerate(rows1):
            lib[i] = lib_of_rg.get(r.rg, 0)
    if paired:
        t1 = np.array([r.tid for r in rows1])
        t2 = np.array([r.tid for r in rows2])
        ok1 = np.array([r.aln.aligned for r in rows1])
        ok2 = np.array([r.aln.aligned for r in rows2])
        p5_1 = np.array(
            [
                unclipped_5p(r.aln.pos, r.aln.end_pos, r.aln.strand, r.aln.cigar)
                if r.aln.aligned else -1
                for r in rows1
            ]
        )
        p5_2 = np.array(
            [
                unclipped_5p(r.aln.pos, r.aln.end_pos, r.aln.strand, r.aln.cigar)
                if r.aln.aligned else -1
                for r in rows2
            ]
        )
        s1 = np.array([r.aln.strand for r in rows1])
        s2 = np.array([r.aln.strand for r in rows2])
        dup = marker.mark_batch(t1, p5_1, s1, ok1, t2, p5_2, s2, ok2, lib=lib)
        dup &= ok1 | ok2
    else:
        ok1 = np.array([r.aln.aligned for r in rows1])
        p5_1 = np.array(
            [
                unclipped_5p(r.aln.pos, r.aln.end_pos, r.aln.strand, r.aln.cigar)
                if r.aln.aligned else -1
                for r in rows1
            ]
        )
        t1 = np.array([r.tid for r in rows1])
        s1 = np.array([r.aln.strand for r in rows1])
        none = np.full(n, -1)
        dup = marker.mark_batch(
            t1, p5_1, s1, ok1, none, none, none, np.zeros(n, dtype=bool),
            lib=lib,
        )
        dup &= ok1

    # samblaster --maxSplitCount caps the number of split pieces a read
    # may have to enter the splitter file (bin/speedseq:242); this aligner
    # emits at most primary+1 supplementary = 2 pieces, so the cap gates
    # splitter emission entirely when set below 2
    split_ok = cfg.max_split_count >= 2
    for i in range(n):
        r1 = rows1[i]
        r2 = rows2[i] if paired else None
        recs = _pair_records(r1, r2, idx, distro, bool(dup[i]), cfg)
        for rec, is_split, is_disc in recs:
            main.append(rec)
            dup_ok = not (rec.flag & FDUP) or cfg.include_dups_in_side
            if is_split and dup_ok and split_ok:
                splitters.append(strip_seq(rec))
            if is_disc and dup_ok:
                discordants.append(strip_seq(rec))
    return main, splitters, discordants


def _pair_records(
    r1: _PairRow, r2: Optional[_PairRow], idx: BWAIndex,
    distro: InsertDistro, is_dup: bool, cfg: AlignConfig,
):
    """Emit (record, in_splitters, in_discordants) for one template."""
    offsets = np.asarray(idx.offsets + [idx.l_pac], dtype=np.int64)

    def cpos(a: HostAlignment):
        tid = int(np.searchsorted(offsets, a.pos, side="right") - 1)
        return tid, a.pos - int(offsets[tid])

    out = []
    ends = [(r1, r2, FREAD1), (r2, r1, FREAD2)] if r2 is not None else [(r1, None, 0)]
    # precompute chrom coords
    infos = {}
    for r, _, _ in ends:
        if r is not None and r.aln.aligned:
            tid, p = cpos(r.aln)
            infos[id(r)] = (tid, p, r.aln.end_pos - r.aln.pos + p)
    # proper-pair determination
    proper = False
    if r2 is not None and r1.aln.aligned and r2.aln.aligned:
        proper = is_proper(
            r1.aln.pos, r1.aln.end_pos, r1.aln.strand,
            r2.aln.pos, r2.aln.end_pos, r2.aln.strand,
            distro, same_tid=(r1.tid == r2.tid),
        )
    both_mapped = (
        r2 is not None and r1.aln.aligned and r2.aln.aligned
    )
    discordant = both_mapped and not proper

    for r, mate, read_flag in ends:
        if r is None:
            continue
        a = r.aln
        flag = read_flag
        if r2 is not None:
            flag |= FPAIRED
        if proper:
            flag |= FPROPER_PAIR
        if not a.aligned:
            flag |= FUNMAP
        if a.aligned and a.strand:
            flag |= FREVERSE
        if mate is not None:
            if not mate.aln.aligned:
                flag |= FMUNMAP
            elif mate.aln.strand:
                flag |= FMREVERSE
        if is_dup:
            flag |= FDUP

        if a.aligned:
            tid, pos, _end = infos[id(r)]
        elif mate is not None and mate.aln.aligned:
            tid, pos, _end = infos[id(mate)]
        else:
            tid, pos = -1, -1
        if mate is not None and mate.aln.aligned:
            mtid, mpos, _mend = infos[id(mate)]
        elif a.aligned and mate is not None:
            mtid, mpos = tid, pos  # mate unmapped: placed with this read
        else:
            mtid, mpos = (tid, pos) if not a.aligned else (-1, -1)
        if r2 is None:
            mtid, mpos = -1, -1

        tlen = 0
        if both_mapped and r.tid == mate.tid:
            left = min(a.pos, mate.aln.pos)
            right = max(a.end_pos, mate.aln.end_pos)
            if a.pos < mate.aln.pos or (a.pos == mate.aln.pos and read_flag == FREAD1):
                tlen = right - left
            else:
                tlen = -(right - left)

        seq = r.seq if not (a.aligned and a.strand) else r.seq_rc
        qual = r.qual if not (a.aligned and a.strand) else r.qual_r
        tags = []
        if a.aligned:
            # MD only when the host computed it (bwa mem itself emits no MD;
            # the pallas path reports NM from the traceback kernel)
            tags += ([("MD", "Z", a.md)] if a.md else [])
            tags += [("NM", "i", a.nm), ("AS", "i", a.score),
                     ("XS", "i", a.sub_score)]
        tags.append(("RG", "Z", r.rg or cfg.rg_id))
        if mate is not None and mate.aln.aligned:
            # samblaster --addMateTags contract (bin/speedseq:439)
            tags.append(("MC", "Z", cigar_to_str(mate.aln.cigar)))
            tags.append(("MQ", "i", mate.aln.mapq))
        # slot-1 candidate: a split piece (query-disjoint → SA tag +
        # supplementary record, samblaster splitter channel) or an XA
        # secondary (query-overlapping alternative placement, bwa's
        # XA:Z:chr,±pos,CIGAR,NM; emitted when within 80% of the primary
        # score [external knowledge: bwa mem XA contract])
        has_supp = a.aligned and r.supp is not None
        split_ok = False
        if has_supp:
            qlen = len(r.seq)
            pq = _cigar_qspan(a.cigar)
            sq = _cigar_qspan(r.supp.cigar)
            pb, pe = _orig_frame(pq[0], pq[1], a.strand, qlen)
            sb, se = _orig_frame(sq[0], sq[1], r.supp.strand, qlen)
            split_ok = split_qualifies(pb, pe, sb, se, cfg.min_non_overlap)
        has_split = has_supp and split_ok
        if has_split:
            stid, spos = cpos(r.supp)
            tags.append(
                (
                    "SA",
                    "Z",
                    make_sa_tag(
                        idx.names[stid], spos, r.supp.strand, r.supp.cigar,
                        r.supp.mapq, r.supp.nm,
                    ),
                )
            )
        elif has_supp and r.supp.score >= 0.8 * a.score:
            stid, spos = cpos(r.supp)
            tags.append((
                "XA", "Z",
                f"{idx.names[stid]},{'-' if r.supp.strand else '+'}"
                f"{spos + 1},{cigar_to_str(r.supp.cigar)},{r.supp.nm};",
            ))

        rec = SAMRecord(
            qname=r.name, flag=flag, tid=tid, pos=pos,
            mapq=a.mapq if a.aligned else 0,
            cigar=a.cigar if a.aligned else [],
            mtid=mtid, mpos=mpos, tlen=tlen, seq=seq, qual=qual, tags=tags,
        )
        out.append((rec, has_split, discordant))

        if has_split:
            stid, spos = cpos(r.supp)
            sflag = flag | FSUPPLEMENTARY
            if r.supp.strand:
                sflag |= FREVERSE
            else:
                sflag &= ~FREVERSE
            sseq = r.seq if not r.supp.strand else r.seq_rc
            squal = r.qual if not r.supp.strand else r.qual_r
            stags = [
                ("NM", "i", r.supp.nm),
                *([("MD", "Z", r.supp.md)] if r.supp.md else []),
                ("AS", "i", r.supp.score), ("RG", "Z", r.rg or cfg.rg_id),
                (
                    "SA", "Z",
                    make_sa_tag(
                        idx.names[tid], pos, a.strand, a.cigar, a.mapq, a.nm
                    ),
                ),
            ]
            srec = SAMRecord(
                qname=r.name, flag=sflag, tid=stid, pos=spos,
                mapq=r.supp.mapq, cigar=r.supp.cigar, mtid=mtid, mpos=mpos,
                tlen=0, seq=sseq, qual=squal, tags=stags,
            )
            out.append((srec, True, False))
    return out


def _cigar_qspan(cigar) -> Tuple[int, int]:
    """(qbeg, qend) covered by non-clip query ops, strand frame."""
    lead = cigar[0][1] if cigar and cigar[0][0] in (4, 5) else 0
    span = sum(l for op, l in cigar if op in (0, 1, 7, 8))
    return lead, lead + span


def sort_key(rec: SAMRecord) -> Tuple[int, int, int]:
    """samtools coordinate-sort key: tid<<32|(pos+1)<<1|is_rev
    (src/samtools-1.3.1/bam_sort.c:1612); unmapped (tid<0) last.
    The external sorter (formats.extsort) implements the same key
    columnarly; this scalar form is kept for tests/verification."""
    tid = rec.tid if rec.tid >= 0 else 1 << 30
    return (tid, rec.pos + 1, 1 if rec.flag & FREVERSE else 0)
