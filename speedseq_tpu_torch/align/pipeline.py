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

With a mesh (``device=`` a parallel.mesh.Mesh, or on ``cuda`` when more
than one card is visible and divides the batch), each batch's step runs
sharded over the mesh (parallel.mesh.distributed_fused_step); the records
do not change.  ``SSQ_TORCH_TRACE=<dir>`` records the whole run with
``torch.profiler`` and writes a Chrome trace into ``<dir>``.
"""

from __future__ import annotations

import os
import pickle
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..formats import bai, fastq
from ..formats.sam import FDUP, SAMHeader
from ..index.bwt import build_index, load_index
from ..index.fm import FMIndex, _reconstruct_sa
from ..index.kmer import kmer_arrays_np, kmer_index_from_arrays
from ..utils.metrics import metrics
from ..utils.prefetch import prefetch
from .core import (DEFAULT_DISTRO, device_estimate_distro, fused_align_leaves,
                   pack_leaves, unpack_fused, unpack_leaves, unpack_xa)
from .markdup import StreamDupMarker
from .pairing import InsertDistro

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
        if not os.path.exists(reference + ".bwt"):
            idx = build_index(reference)
        else:
            idx = load_index(reference)
        host = (_full_sa(reference, idx) if seed_mode == "fm"
                else kmer_arrays_np(idx.pac))
        hit = (mtime, idx, host)
        _host_cache.clear()
        _host_cache[key] = hit
    _, idx, host = hit
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


def _step_events(device: torch.device):
    """A started (begin, end) CUDA event pair around one device step
    (None off the card): its elapsed time is the step's device time."""
    if device.type != "cuda":
        return None
    evs = (torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
    evs[0].record()
    return evs


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
    trace_dir = os.environ.get("SSQ_TORCH_TRACE")
    if not trace_dir:
        return _align_stream(reference, batch_iter, out_prefix, config,
                             rg_lines, paired, marker, device,
                             sorter_factory, pre_close)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = _align_stream(reference, batch_iter, out_prefix, config,
                            rg_lines, paired, marker, device,
                            sorter_factory, pre_close)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"align-{os.getpid()}-{int(time.time() * 1000)}.json"))
    return out


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


def _align_stream(reference, batch_iter, out_prefix, config, rg_lines,
                  paired, marker, device, sorter_factory, pre_close):
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
            # both events completed before the fetch's own event
            ev0, ev1 = item["step_ev"]
            metrics.add("align.device_step_s", ev0.elapsed_time(ev1) / 1e3)
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
        for bi, (b1, b2) in enumerate(prefetch(batch_iter)):
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
                step_ev = None if mesh is not None else _step_events(dev)
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
                    i32_d, i16_d, cigfull_d, stats_d = fused_align_leaves(
                        fm, *step_args, paired=is_paired_batch, **step_kw)
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
                "step_ev": step_ev,
            }
            drain_futs.append(drain_pool.submit(_drain, item))
            # bounded look-ahead: at most 2 batches of fetched arrays live
            while len(drain_futs) > 2:
                drain_futs.popleft().result()
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

    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)

    # finalize the 3 outputs concurrently (sorter merge + BGZF write + BAI
    # build each), as the reference co-schedules with `parallel -j 3`
    def _close_one(key_suffix):
        key, suffix = key_suffix
        sorters[key].close()
        path = out_prefix + suffix
        if not getattr(sorters[key], "skip_bai", False):
            bai.build_bai(path)
        return suffix[1:], path

    if pre_close is not None:
        # the multi-process dup marker pads its exchange waves before any
        # sorter closes: a process's close-time exchanges must not pair
        # with a peer still waiting in a marker wave
        pre_close()
    if sorter_factory is not None:
        # one after another, in stream order: factory sorters may make
        # exchanges while closing
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
