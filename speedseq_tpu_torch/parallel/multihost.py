"""Multi-process runs of align, var, somatic and sv.

Counterpart of speedseq_tpu/parallel/multihost.py, with its host logic
copied and its JAX runtime replaced by torch.distributed:

- **per-process input sharding**: FASTQ batches are assigned round-robin
  by batch index (process p takes global batches p, p+P, …), so the
  concatenation of all processes' streams in (wave, process) order equals
  the single-process stream order exactly.
- **device work**: each process runs the production align step on its
  own device, ``cuda:{LOCAL_RANK % device_count}`` by default (several
  processes may share one card) or the CPU when asked (``--device cpu``).
- **global duplicate marking**: samblaster's first-seen semantics must
  hold across processes.  Each wave, processes allgather their batch's
  dup signatures and every process applies all P batches to an identical
  replicated signature table in (wave, process) order —
  :class:`WaveSyncDupMarker`.  The transport is :class:`CollectiveExchange`
  (torch.distributed over gloo: every payload is host bytes) when a
  process group of the run's size is up, else the file-based
  :class:`FileExchange` (a shared directory, the reference's
  files-as-transport); payloads are packed int64 signature matrices.
- **deterministic global merge**: each process writes sorted per-process
  parts, each record tagged with its wave (:class:`WaveTagSorter`);
  process 0 k-way merges them on (samtools coordinate key, wave,
  process), which is the single-process stream's order of equal keys,
  and builds the BAI — or, with ``reshard=True``, every wave's records
  travel to their genome-range owner (:class:`ReshardingSorter`) and
  process 0 concatenates the per-range parts.

Run one process per rank: ``python -m speedseq_tpu_torch.parallel.multihost
align|var|sv ...`` under torchrun (``env://``), or with ``SSQ_COORDINATOR=
host:port`` and the world size and rank in the arguments, or with neither
(the exchange then goes through the shared directory).  Two reference
faults are not copied: a resharded run checkpoints and resumes
(``ReshardingSorter.spill/state/restore``), and the final assembly streams
its parts in bounded chunks.  A third is repaired: the reference merges
untagged per-process BAMs with ties in process order, so two records of
one coordinate from batches 2 and 1 (processes 0 and 1) come out in the
wrong order; the wave tag orders them as one process would.
"""

from __future__ import annotations

import datetime
import os
import struct
import time
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..align.markdup import StreamDupMarker

EXCHANGE_TIMEOUT_S = 300.0


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout: float = EXCHANGE_TIMEOUT_S,
) -> None:
    """torch.distributed bring-up (gloo).  The address is ``coordinator``
    or ``SSQ_COORDINATOR`` (``host:port``), else torchrun's ``env://``
    (MASTER_ADDR, WORLD_SIZE, RANK); the world size and rank default to
    WORLD_SIZE and RANK.  Does nothing for one process, with no address,
    or when a group is already up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator is None:
        coordinator = os.environ.get("SSQ_COORDINATOR")
    if num_processes <= 1:
        return
    if coordinator is not None:
        method = (coordinator if "://" in coordinator
                  else f"tcp://{coordinator}")
    elif "MASTER_ADDR" in os.environ:
        method = "env://"
    else:
        return
    dist.init_process_group(
        "gloo", init_method=method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def worker_device(device: Optional[str] = None,
                  process_id: int = 0) -> torch.device:
    """A worker's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK % device_count}`` (LOCAL_RANK defaults to the
    process id).  Asking for cuda without a card raises."""
    from ..device import resolve_device

    if device is not None:
        dev = resolve_device(device)
    else:
        resolve_device("cuda")
        rank = int(os.environ.get("LOCAL_RANK", process_id))
        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)      # the worker's allocations go there
    return dev


class FileExchange:
    """Filesystem allgather: write-one, read-all, per wave.

    Writes are atomic (tmp + rename); readers spin-wait with a timeout.
    This is deliberately the same transport class the reference uses for
    its global exchanges (files + sort, bin/speedseq:800-806) — a shared
    filesystem plays this role; the payload is tiny (new dup signatures
    per batch)."""

    def __init__(self, root: str, num_processes: int, process_id: int,
                 timeout: float = EXCHANGE_TIMEOUT_S,
                 run_id: Optional[str] = None):
        if run_id is None:
            # workers of one run share the launcher process, so a
            # ppid-derived default is identical across them but differs
            # between sequential runs — a CONSTANT default would let a
            # reused exchange_dir satisfy allgather with the previous
            # run's wave files (pass an explicit run_id in production)
            run_id = f"run{os.getppid()}"
        self.root = root
        self.P = num_processes
        self.pid = process_id
        self.timeout = timeout
        # run_id scopes every filename: reusing an exchange_dir across
        # runs can otherwise satisfy the allgather with stale payloads
        # from the previous run (silently corrupting global dup marking).
        # All processes of one run must pass the same run_id; a mismatch
        # fails loudly with TimeoutError instead of reading stale data.
        self.run_id = run_id
        os.makedirs(root, exist_ok=True)
        # hygiene: drop this process's leftovers from PRIOR runs only —
        # an age guard keeps a concurrent run sharing this exchange_dir
        # from having its live wave files deleted
        prefix = f"{run_id}."
        now = time.time()
        for name in os.listdir(root):
            if not name.startswith(prefix) and name.endswith(f".p{process_id}"):
                try:
                    path = os.path.join(root, name)
                    if now - os.path.getmtime(path) > 600:
                        os.unlink(path)
                except OSError:
                    pass

    def _path(self, wave: int, pid: int) -> str:
        return os.path.join(self.root, f"{self.run_id}.w{wave:06d}.p{pid}")

    def allgather(self, wave: int, payload: bytes) -> List[bytes]:
        mine = self._path(wave, self.pid)
        self._write_atomic(mine, payload)
        return [self._read_wait(self._path(wave, p), wave, p)
                for p in range(self.P)]

    def alltoall(self, wave: int, payloads: List[bytes]) -> List[bytes]:
        """Send payloads[d] to process d; receive one payload from every
        process.  File layout: one file per (wave, src, dst)."""
        assert len(payloads) == self.P
        for d, pl in enumerate(payloads):
            self._write_atomic(self._a2a_path(wave, self.pid, d), pl)
        return [self._read_wait(self._a2a_path(wave, p, self.pid), wave, p)
                for p in range(self.P)]

    def _a2a_path(self, wave: int, src: int, dst: int) -> str:
        return os.path.join(
            self.root, f"{self.run_id}.w{wave:06d}.s{src}.p{dst}")

    def _write_atomic(self, path: str, payload: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(struct.pack("<q", len(payload)))
            fh.write(payload)
        os.replace(tmp, path)

    def _read_wait(self, path: str, wave: int, p: int) -> bytes:
        deadline = time.time() + self.timeout
        while True:
            try:
                with open(path, "rb") as fh:
                    (ln,) = struct.unpack("<q", fh.read(8))
                    data = fh.read(ln)
                if len(data) == ln:
                    return data
            except (FileNotFoundError, struct.error):
                pass
            if time.time() > deadline:
                raise TimeoutError(
                    f"exchange wave {wave}: process {p} missing")
            time.sleep(0.005)


_EMPTY = np.zeros(0, np.int64)


class CollectiveExchange:
    """The wave interface of FileExchange over torch.distributed
    collectives (the process group ``init_distributed`` started; gloo,
    as every payload is host bytes).  Collectives pair up by call order,
    so the wave number only names a wave in errors.  A collective that
    fails on the group's timeout raises TimeoutError."""

    def __init__(self):
        import torch.distributed as dist

        self._dist = dist
        self.P = dist.get_world_size()
        self.pid = dist.get_rank()

    def _call(self, wave: int, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except RuntimeError as e:
            if "timed out" in str(e).lower() or "timeout" in str(e).lower():
                raise TimeoutError(f"exchange wave {wave}: {e}") from e
            raise

    def allgather(self, wave: int, payload: bytes) -> List[bytes]:
        dist = self._dist
        ln = torch.tensor([len(payload)], dtype=torch.int64)
        lens = [torch.zeros(1, dtype=torch.int64) for _ in range(self.P)]
        self._call(wave, dist.all_gather, lens, ln)
        lens = [int(x) for x in lens]
        m = max(max(lens), 1)
        buf = torch.zeros(m, dtype=torch.uint8)
        if payload:
            buf[: len(payload)] = torch.frombuffer(bytearray(payload),
                                                   dtype=torch.uint8)
        got = [torch.zeros(m, dtype=torch.uint8) for _ in range(self.P)]
        self._call(wave, dist.all_gather, got, buf)
        return [g[: lens[p]].numpy().tobytes() for p, g in enumerate(got)]

    def alltoall(self, wave: int, payloads: List[bytes]) -> List[bytes]:
        """Send payloads[d] to process d; receive one from every process
        (``all_to_all_single`` with split sizes, after an all-to-all of
        the sizes)."""
        assert len(payloads) == self.P
        dist = self._dist
        send_lens = torch.tensor([len(p) for p in payloads],
                                 dtype=torch.int64)
        recv_lens = torch.zeros(self.P, dtype=torch.int64)
        self._call(wave, dist.all_to_all_single, recv_lens, send_lens)
        cat = b"".join(payloads)
        send = (torch.frombuffer(bytearray(cat), dtype=torch.uint8) if cat
                else torch.zeros(0, dtype=torch.uint8))
        recv = torch.zeros(int(recv_lens.sum()), dtype=torch.uint8)
        self._call(wave, dist.all_to_all_single, recv, send,
                   output_split_sizes=recv_lens.tolist(),
                   input_split_sizes=send_lens.tolist())
        out, at = [], 0
        for n in recv_lens.tolist():
            out.append(recv[at: at + n].numpy().tobytes())
            at += n
        return out


def make_exchange(exchange_dir: str, num_processes: int, process_id: int,
                  run_id: Optional[str] = None):
    """CollectiveExchange when a process group of the run's size is up;
    FileExchange when none is.  A group of another size is a
    misconfigured run and raises."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is "
                f"up, but the run has {num_processes}")
        if dist.get_rank() != process_id:
            raise RuntimeError(
                f"process group rank {dist.get_rank()} != process id "
                f"{process_id}")
        return CollectiveExchange()
    return FileExchange(exchange_dir, num_processes, process_id,
                        run_id=run_id)


class WaveSyncDupMarker(StreamDupMarker):
    """Replicated-table duplicate marker: every process applies every
    process's batch signatures in (wave, process) order, so all tables
    stay identical and first-seen resolution equals the single-process
    stream order.

    Payloads are a packed (n, k) int64 signature matrix (no pickle)."""

    RESUME_WAVE = 10 ** 6 + 1

    def __init__(self, exchange):
        super().__init__()
        self.ex = exchange
        self.wave = 0

    def mark_batch(self, tid1, p5_1, st1, ok1, tid2, p5_2, st2, ok2,
                   lib=None):
        args = [np.asarray(a, np.int64) for a in
                (tid1, p5_1, st1, ok1, tid2, p5_2, st2, ok2)]
        if lib is not None:
            args.append(np.asarray(lib, np.int64))
        k = len(args)
        mat = (np.stack(args, axis=1) if args[0].size
               else np.zeros((0, k), np.int64))
        payload = bytes([k]) + mat.tobytes()
        peers = self.ex.allgather(self.wave, payload)
        self.wave += 1
        mine = None
        for p, pl in enumerate(peers):
            kp = pl[0]
            m = np.frombuffer(pl[1:], np.int64).reshape(-1, kp)
            cols = [m[:, i] for i in range(kp)]
            lib_p = cols[8] if kp > 8 else None
            d = super().mark_batch(*cols[:8], lib=lib_p)
            if p == self.ex.pid:
                mine = d
        return mine

    def finish(self, total_waves: int) -> None:
        """Participate in waves past this process's last batch (other
        processes may still be streaming)."""
        while self.wave < total_waves:
            self.mark_batch(_EMPTY, _EMPTY, _EMPTY, _EMPTY,
                            _EMPTY, _EMPTY, _EMPTY, _EMPTY)

    def agree_resume(self, batches: List[int]) -> int:
        """The batch every process resumes at: the last one that all of
        them checkpointed (``batches``: this process's checkpointed batch
        counts, ascending; 0 when they share none).  align_stream calls
        this on ``resume``; waves restart there."""
        got = self.ex.allgather(self.RESUME_WAVE,
                                np.asarray(batches, np.int64).tobytes())
        common = set(batches)
        for pl in got:
            common &= set(np.frombuffer(pl, np.int64).tolist())
        at = max(common, default=0)
        self.wave = at
        return at


def launch_counts() -> str:
    """This process's kernel launches so far (the ops wrappers' counts),
    as JSON: what the worker lines print."""
    import json

    from ..ops import fm_search, seed_chain, sv_cluster, sw_banded

    return json.dumps({**sw_banded.LAUNCHES, **fm_search.LAUNCHES,
                       **sv_cluster.LAUNCHES, **seed_chain.LAUNCHES})


def _shard_batches(batch_iter, num_processes: int, process_id: int):
    for bi, item in enumerate(batch_iter):
        if bi % num_processes == process_id:
            yield item


# ---------------------------------------------------------------------------
# coordinate re-sharding: per-range parts instead of one merge on process 0
# ---------------------------------------------------------------------------

def coordinate_boundaries(refs, num_processes: int) -> np.ndarray:
    """(P-1,) packed-sort-key upper bounds splitting the genome into P
    contiguous, ~equal-bp ranges.  Keys are the samtools coordinate sort
    key ``tid<<33|(pos+1)<<1|rev`` (bam_sort.c:1612 semantics,
    formats/extsort.packed_keys); unmapped records (tid sentinel, max
    key) fall into the last range."""
    lens = np.asarray([ln for _, ln in refs], np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    total = int(cum[-1])
    bounds = []
    for k in range(1, num_processes):
        target = total * k // num_processes
        tid = int(np.searchsorted(cum, target, side="right") - 1)
        tid = min(tid, len(lens) - 1)
        pos = int(target - cum[tid])
        bounds.append((np.int64(tid) << 33) | (np.int64(pos + 1) << 1))
    return np.asarray(bounds, np.int64)


class ReshardingSorter:
    """Per-stream coordinate re-shard: every batch's record columns are
    routed to their genome-range owner over ``exchange.alltoall`` and
    each process sorts and compresses ONLY its own range into a
    headerless BGZF part.  The final BAM is assembled by concatenating
    the parts' BGZF members, so sorting and compression spread over the
    processes instead of funnelling through process 0's k-way merge.

    Wave protocol: every process calls ``add_columns`` once per wave per
    stream (empty batches included — ``finish`` pads to ``total_waves``),
    so the per-(wave, stream) all-to-alls pair up across processes;
    within a wave the receive order is process rank, which equals
    single-stream batch order under round-robin input sharding — record
    order (and every tie) is identical to the single-process run.

    ``spill``/``state``/``restore`` make it a checkpointable sorter of
    align_stream (the reference's lacks them, so its resharded runs could
    not checkpoint): the state is the part sorter's chunk list and the
    wave count."""

    skip_bai = True           # parts are headerless; BAI built post-assembly

    def __init__(self, part_path: str, header, exchange,
                 boundaries: np.ndarray, stream_idx: int,
                 total_waves: int, max_records: int = 200_000):
        from ..formats.extsort import ExternalBAMSorter

        self.ex = exchange
        self.bounds = boundaries
        self.stream = stream_idx
        self.total_waves = total_waves
        self.wave = 0
        self.part_path = part_path
        self.inner = ExternalBAMSorter(
            part_path, header, headerless=True, max_records=max_records)
        self.n_records = 0

    def add_columns(self, cols) -> None:
        if cols.n == 0:
            self._route(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.uint8))
            return
        self._route(cols.sort_keys(),
                    cols.record_sizes().astype(np.int64),
                    np.frombuffer(cols.encode(), np.uint8))

    def _route(self, keys, sizes, blob) -> None:
        P = self.ex.P
        starts = np.zeros(len(sizes), np.int64)
        if len(sizes):
            np.cumsum(sizes[:-1], out=starts[1:])
        tgt = np.searchsorted(self.bounds, keys, side="right")
        payloads = []
        for d in range(P):
            sel = np.nonzero(tgt == d)[0]          # intake order preserved
            pb = native.gather_records(blob, starts, sizes, sel)
            payloads.append(
                struct.pack("<q", len(sel)) + keys[sel].tobytes()
                + sizes[sel].tobytes() + pb.tobytes())
        got = self.ex.alltoall(self.wave * 8 + self.stream, payloads)
        self.wave += 1
        for pl in got:                             # rank order = batch order
            (n,) = struct.unpack_from("<q", pl, 0)
            if not n:
                continue
            k = np.frombuffer(pl, np.int64, n, 8)
            sz = np.frombuffer(pl, np.int64, n, 8 + 8 * n)
            bl = np.frombuffer(pl, np.uint8, offset=8 + 16 * n)
            self.inner.add_keyed_blob(k.copy(), sz.copy(), bl.copy())
            self.n_records += n

    def spill(self) -> None:
        self.inner.spill()

    def state(self) -> dict:
        return {"inner": self.inner.state(), "wave": self.wave,
                "n_records": self.n_records}

    def restore(self, state: dict) -> None:
        self.inner.restore(state["inner"])
        self.wave = state["wave"]
        self.n_records = state["n_records"]

    def finish(self) -> None:
        while self.wave < self.total_waves:
            self._route(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.uint8))

    def close(self) -> None:
        self.finish()
        self.inner.close()


class WaveTagSorter:
    """The per-process sorter of a merged (not resharded) run: a
    headerless part of this process's records in coordinate order, each
    record carrying its wave (4 bytes appended, block_size grown to
    match) for process 0's merge (``_merge_wave_tagged``), which orders
    equal keys by (wave, process): the single-process batch order.
    Checkpointable like ReshardingSorter."""

    skip_bai = True

    def __init__(self, part_path: str, header, max_records: int = 200_000):
        from ..formats.extsort import ExternalBAMSorter

        self.part_path = part_path
        self.wave = 0
        self.inner = ExternalBAMSorter(
            part_path, header, headerless=True, max_records=max_records)

    def add_columns(self, cols) -> None:
        if cols.n:
            sizes = cols.record_sizes().astype(np.int64)
            self.inner.add_keyed_blob(
                cols.sort_keys(), sizes + 4,
                _append_wave(np.frombuffer(cols.encode(), np.uint8), sizes,
                             self.wave))
        self.wave += 1

    def spill(self) -> None:
        self.inner.spill()

    def state(self) -> dict:
        return {"inner": self.inner.state(), "wave": self.wave}

    def restore(self, state: dict) -> None:
        self.inner.restore(state["inner"])
        self.wave = state["wave"]

    def close(self) -> None:
        self.inner.close()


def _append_wave(blob: np.ndarray, sizes: np.ndarray, wave: int) -> np.ndarray:
    """Records (block_size-prefixed, ``sizes`` bytes each) with the int32
    ``wave`` appended to each and block_size grown by 4."""
    n = len(sizes)
    starts = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    shift = 4 * np.arange(n, dtype=np.int64)
    out = np.empty(len(blob) + 4 * n, np.uint8)
    out[np.arange(len(blob)) + np.repeat(shift, sizes)] = blob
    four = np.arange(4)
    out[(starts + shift)[:, None] + four] = (
        sizes.astype("<i4").view(np.uint8).reshape(n, 4))
    out[(starts + sizes + shift)[:, None] + four] = np.frombuffer(
        struct.pack("<i", wave), np.uint8)
    return out


def _wave_tagged(path: str, pid: int):
    """(key, wave, pid, record) of a WaveTagSorter part, in part order;
    the record without its tag, as BAMWriter.write_raw takes it."""
    from ..formats.bgzf import BGZFReader
    from ..formats.extsort import _TID_UNMAPPED
    from ..formats.sam import FREVERSE

    r = BGZFReader(path)
    try:
        while True:
            hdr = r.read(4)
            if len(hdr) < 4:
                return
            (sz,) = struct.unpack("<i", hdr)
            raw = r.read(sz)
            tid, pos = struct.unpack_from("<ii", raw, 0)
            (flag,) = struct.unpack_from("<H", raw, 14)
            (wave,) = struct.unpack_from("<i", raw, sz - 4)
            yield ((tid if tid >= 0 else _TID_UNMAPPED, pos + 1,
                    1 if flag & FREVERSE else 0), wave, pid, raw[:-4])
    finally:
        r.close()


def _merge_wave_tagged(parts: List[str], header, out_path: str) -> None:
    """k-way merge of WaveTagSorter parts (part p from process p) into one
    BAM, equal keys in (wave, process) order: the single-process order."""
    import heapq

    from ..formats.bam import BAMWriter

    with BAMWriter(out_path, header) as w:
        for t in heapq.merge(*(_wave_tagged(p, i) for i, p in
                               enumerate(parts)), key=lambda t: t[:3]):
            w.write_raw(t[3])


ASSEMBLE_CHUNK = 1 << 22


def _copy_members(src: str, out, chunk: int = ASSEMBLE_CHUNK) -> None:
    """Copy a BGZF file's members to ``out`` without its EOF marker, in
    chunks of at most ``chunk`` bytes."""
    from ..formats.bgzf import BGZF_EOF

    size = os.path.getsize(src)
    with open(src, "rb") as fh:
        fh.seek(max(size - len(BGZF_EOF), 0))
        end = size - len(BGZF_EOF) if fh.read() == BGZF_EOF else size
        fh.seek(0)
        left = end
        while left:
            buf = fh.read(min(chunk, left))
            out.write(buf)
            left -= len(buf)


def _assemble_resharded(parts: List[str], header, out_path: str,
                        chunk: int = ASSEMBLE_CHUNK) -> None:
    """Concatenate headerless per-range BGZF parts (in range order) into
    one BAM: header member + each part minus its EOF marker + one EOF.
    BGZF members concatenate into a valid BGZF stream, so assembly is
    pure byte IO, streamed in bounded chunks (the reference reads each
    part whole into memory)."""
    from ..formats.bam import BAMWriter
    from ..formats.bgzf import BGZF_EOF

    hdr_tmp = out_path + ".hdr.tmp"
    BAMWriter(hdr_tmp, header).close()
    with open(out_path, "wb") as out:
        for p in [hdr_tmp] + list(parts):
            _copy_members(p, out, chunk)
        out.write(BGZF_EOF)
    os.unlink(hdr_tmp)


def align_fastq_multihost(
    reference: str,
    fq1: str,
    fq2: Optional[str],
    out_prefix: str,
    config,
    num_processes: int,
    process_id: int,
    exchange_dir: str,
    run_id: Optional[str] = None,
    reshard: bool = False,
    device=None,
) -> Optional[dict]:
    """One process's share of a multi-process align run, on ``device``
    (``worker_device``'s choice when None).

    Every process calls this with its process_id; process 0 returns the
    final merged output paths, others return None.  ``run_id`` must be
    identical across processes of one run and fresh per run (it scopes
    the exchange files; see FileExchange).  With ``config.checkpoint``
    and ``config.resume`` a killed run resumes, at the last batch every
    process checkpointed (WaveSyncDupMarker.agree_resume).

    ``reshard=True`` switches the global exchange from "per-process
    sorted parts + process-0 k-way merge" to the coordinate re-shard
    (ReshardingSorter): every wave's records travel to their genome-
    range owner over the all-to-all, each process sorts and compresses
    only its range, and process 0 assembles the final BAMs by BGZF-member
    concatenation."""
    from ..align.pipeline import align_stream
    from ..formats import fastq

    dev = worker_device(device, process_id)
    ex = make_exchange(exchange_dir, num_processes, process_id,
                       run_id=run_id)
    marker = WaveSyncDupMarker(ex)
    batches = list(fastq.iter_batches(
        fq1, batch_size=config.batch_size, max_len=config.max_read_len,
        paired_with=fq2, interleaved=False,
    ))
    total_waves = (len(batches) + num_processes - 1) // num_processes
    mine = list(_shard_batches(batches, num_processes, process_id))
    part_prefix = f"{out_prefix}.part{process_id}"
    hdr_box = {}
    stream_idx = {"bam": 0, "splitters": 1, "discordants": 2}

    def factory(key, path, header):
        hdr_box["header"] = header
        if not reshard:
            return WaveTagSorter(path, header,
                                 max_records=config.sort_max_records)
        return ReshardingSorter(
            f"{path}.rpart{process_id}", header, ex,
            coordinate_boundaries(header.refs, num_processes),
            stream_idx[key], total_waves,
            max_records=config.sort_max_records)

    t0 = time.time()
    align_stream(
        reference, iter(mine), part_prefix, config,
        paired=fq2 is not None, marker=marker, device=dev,
        sorter_factory=factory,
        pre_close=lambda: marker.finish(total_waves),
    )
    t_align = time.time() - t0
    # barrier: announce completion, wait for all parts
    ex.allgather(10**6, b"done")
    print(f"[align-mh] p{process_id}: {type(ex).__name__} on {dev}: "
          f"align {t_align:.2f}s exchange {time.time() - t0 - t_align:.2f}s "
          f"launches {launch_counts()}", flush=True)
    if process_id != 0:
        return None
    from ..formats import bai

    outputs = {}
    for suffix, key in ((".bam", "bam"), (".splitters.bam", "splitters.bam"),
                        (".discordants.bam", "discordants.bam")):
        out = out_prefix + suffix
        if reshard:
            parts = [f"{out_prefix}.part{p}{suffix}.rpart{p}"
                     for p in range(num_processes)]
            _assemble_resharded(parts, hdr_box["header"], out)
        else:
            parts = [f"{out_prefix}.part{p}{suffix}"
                     for p in range(num_processes)]
            _merge_wave_tagged(parts, hdr_box["header"], out)
        bai.build_bai(out)
        outputs[key] = out
        for p in parts:
            for e in ("", ".bai"):
                try:
                    os.unlink(p + e)
                except OSError:
                    pass
    print(f"[align-mh] p0: merge {time.time() - t0 - t_align:.2f}s",
          flush=True)
    return outputs


def var_multihost(
    reference: str,
    bam_paths: List[str],
    output: str,
    num_processes: int,
    process_id: int,
    exchange_dir: str,
    run_id: Optional[str] = None,
    windows_bed: Optional[str] = None,
    config=None,
    somatic: bool = False,
    device=None,
) -> Optional[str]:
    """One process's share of a multi-process var (or somatic) run, on
    ``device`` (``worker_device``'s choice when None).

    Windows are assigned round-robin over the deterministic
    longest-first order (the reference fans freebayes windows over all
    cores the same way it fans align pipelines, bin/speedseq:719 vs
    :449); each process writes a sorted part, the exchange barrier
    synchronizes, and process 0 performs the deterministic k-way merge
    into the final vcf.gz + tbi (record-for-record equal to a
    single-process run).  ``somatic=True`` runs the pooled-discrete
    [normal, tumor] engine + SSC filter over the same window fan-out (the
    reference's somatic IS freebayes with its awk filter,
    bin/speedseq:1059-1077); bam_paths must then be [normal, tumor].
    Prints per-process wall-clock and exchange/merge overhead."""
    import heapq

    from ..var.engine import VarConfig, _sample_map, build_var_header, run_var

    dev = worker_device(device, process_id)
    record_filter = None
    if somatic:
        from ..var.somatic import SomaticConfig, somatic_filter

        scfg = SomaticConfig()
        cfg = config or VarConfig(
            min_qual=0.0, caller=scfg.caller, apply_balance_filter=False)
        record_filter = somatic_filter(scfg)
    else:
        cfg = config or VarConfig()
    ex = make_exchange(exchange_dir, num_processes, process_id,
                       run_id=run_id)
    part = f"{output}.part{process_id}.vcfraw"
    t0 = time.time()
    run_var(reference, bam_paths, output, windows_bed=windows_bed,
            config=cfg, record_filter=record_filter, device=dev,
            _shard=(num_processes, process_id), _part_out=part)
    t_windows = time.time() - t0
    t0 = time.time()
    ex.allgather(0, b"done")             # barrier: all parts on disk
    if process_id != 0:
        t_ex = time.time() - t0
        print(f"[var-mh] p{process_id}: {type(ex).__name__} on {dev}: "
              f"windows {t_windows:.2f}s exchange {t_ex:.2f}s", flush=True)
        return None
    from ..formats import tabix as tabix_mod
    from ..formats.bam import BAMReader
    from ..formats.vcf import VCFWriter

    def _iter_part(path: str):
        """Stream (key, raw line bytes) entries of one sorted part."""
        with open(path, "rb") as fh:
            while True:
                hdr = fh.read(28)
                if len(hdr) < 28:
                    return
                o, p_, w_, ln = struct.unpack("<qqqI", hdr)
                yield (o, p_, w_), fh.read(ln)

    with BAMReader(bam_paths[0]) as rd0:
        refs = rd0.header.refs
    # rebuild the header exactly as run_var does (same BAMs → same map)
    readers = [BAMReader(p) for p in bam_paths]
    samples, _, _ = _sample_map(readers, bam_paths)
    for rd in readers:
        rd.close()
    header = build_var_header(refs, samples, somatic=somatic)
    if somatic and len(samples) == 2:
        from ..var.somatic import write_ped

        ped = (output[: -len(".vcf.gz")] + ".ped"
               if output.endswith(".vcf.gz") else output + ".ped")
        write_ped(ped, samples[1], samples[0])
    # streaming k-way heap merge of the sorted raw-byte parts: O(P·line)
    # memory.  Equal keys cannot span parts (a window lives on exactly
    # one process), so stream order is deterministic.
    streams = [_iter_part(f"{output}.part{p}.vcfraw")
               for p in range(num_processes)]
    with VCFWriter(output, header) as w:
        for _, line in heapq.merge(*streams, key=lambda t: t[0]):
            w.write_line(line.decode())
    if output.endswith(".gz"):
        tabix_mod.build_tbi(output)
    for p in range(num_processes):
        try:
            os.unlink(f"{output}.part{p}.vcfraw")
        except OSError:
            pass
    t_merge = time.time() - t0
    print(f"[var-mh] p0: {type(ex).__name__} on {dev}: windows "
          f"{t_windows:.2f}s exchange+merge {t_merge:.2f}s", flush=True)
    return output


def sv_multihost(
    samples,
    output: str,
    num_processes: int,
    process_id: int,
    exchange_dir: str,
    run_id: Optional[str] = None,
    config=None,
    device=None,
) -> Optional[str]:
    """One process's share of a multi-process sv run, on ``device``
    (``worker_device``'s choice when None).

    Samples are assigned round-robin (``si % P == pid``) — the
    multi-process counterpart of the reference's per-sample svtyper /
    cnvnator loops (bin/speedseq:1490-1531).  Evidence collection and
    clustering are deterministic and replicated (they consume every
    sample's discordants/splitters); the per-sample SVTyper genotyping +
    CNV depth work shards.  Results are exchanged as fixed-width f64
    matrices over the same transport as the align/var exchanges; process
    0 writes the final vcf.gz + tbi (record-identical to a
    single-process run)."""
    from ..sv.engine import SVConfig, run_sv

    cfg = config or SVConfig()
    ex = make_exchange(exchange_dir, num_processes, process_id,
                       run_id=run_id)
    dev = worker_device(device, process_id)
    out = run_sv(samples, output, cfg, device=dev,
                 _shard=(num_processes, process_id), _exchange=ex)
    print(f"[sv-mh] p{process_id}: {type(ex).__name__} on {dev}: "
          f"launches {launch_counts()}", flush=True)
    return out


def _world(num_p: str, pid: str):
    """(world size, rank) of a worker's arguments; ``env`` takes them from
    WORLD_SIZE and RANK, as torchrun sets them."""
    return (int(os.environ["WORLD_SIZE"] if num_p == "env" else num_p),
            int(os.environ["RANK"] if pid == "env" else pid))


def _share_cores(num_p: int) -> None:
    """Give this worker its share of the host's cores for torch's CPU ops
    (unless OMP_NUM_THREADS says otherwise): workers that each take every
    core spin against each other, many times slower on the CPU path.
    The processes on one host are LOCAL_WORLD_SIZE (torchrun), else all
    ``num_p``."""
    if "OMP_NUM_THREADS" in os.environ:
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_p))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, local)))


def _pop_option(argv: List[str], name: str) -> Optional[str]:
    """Remove ``name VALUE`` from argv; returns VALUE (None if absent)."""
    if name not in argv:
        return None
    i = argv.index(name)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def _sv_worker_main(argv: List[str]) -> int:
    """One process of a multi-process sv run.

    argv: output num_p pid exdir run_id sample_spec... [--device D]
    (num_p and pid may be ``env``: WORLD_SIZE and RANK)
    where sample_spec = name:full:splitters:discordants, or
    ``--depth=<reference>`` for the CNV read-depth pass (-d)."""
    argv = list(argv)
    device = _pop_option(argv, "--device")
    output, num_p, pid, exdir, run_id = argv[:5]
    num_p, pid = _world(num_p, pid)
    _share_cores(num_p)
    from ..sv.engine import SVConfig, SVSample

    cfg = SVConfig()
    samples = []
    for spec in argv[5:]:
        if spec.startswith("--depth="):
            cfg = SVConfig(annotate_depth=True, reference=spec[8:])
            continue
        name, full, spl, disc = spec.split(":")
        samples.append(SVSample(name, full, spl, disc))
    init_distributed(num_processes=num_p, process_id=pid)
    out = sv_multihost(samples, output, num_p, pid, exdir,
                       run_id=run_id, config=cfg, device=device)
    if out is not None:
        print(out)
    return 0


def _var_worker_main(argv: List[str]) -> int:
    """One process of a multi-process var run.

    argv: reference bams(,-joined) output num_p pid exdir run_id
    [window_size] [somatic] [--device D] [--bed WINDOWS.bed]
    (num_p and pid may be ``env``: WORLD_SIZE and RANK)"""
    argv = list(argv)
    device = _pop_option(argv, "--device")
    bed = _pop_option(argv, "--bed")
    (reference, bams, output, num_p, pid, exdir, run_id), rest = (
        argv[:7], argv[7:])
    num_p, pid = _world(num_p, pid)
    _share_cores(num_p)
    init_distributed(num_processes=num_p, process_id=pid)
    from ..var.engine import VarConfig

    somatic = "somatic" in rest
    rest = [r for r in rest if r != "somatic"]
    cfg = None
    if rest:                       # optional window size override
        if somatic:
            from ..var.somatic import SomaticConfig

            cfg = VarConfig(
                min_qual=0.0, caller=SomaticConfig().caller,
                apply_balance_filter=False,
                window_size=int(rest[0]))
        else:
            cfg = VarConfig(window_size=int(rest[0]))
    out = var_multihost(
        reference, bams.split(","), output, num_p, pid, exdir,
        run_id=run_id, windows_bed=bed, config=cfg, somatic=somatic,
        device=device,
    )
    if out is not None:
        print(out)
    return 0


def _worker_main(argv: List[str]) -> int:
    """One process of a multi-process align run.

    argv: reference fq1 fq2 out_prefix num_p pid exdir batch_size
    insert(mean,std,max,min) [run_id] [reshard] [--device D]
    [--checkpoint-every N] [--resume]
    (num_p and pid may be ``env``: WORLD_SIZE and RANK)"""
    import json

    argv = list(argv)
    device = _pop_option(argv, "--device")
    every = _pop_option(argv, "--checkpoint-every")
    resume = "--resume" in argv
    argv = [a for a in argv if a != "--resume"]
    (reference, fq1, fq2, out_prefix, num_p, pid, exdir, batch_size,
     insert), run_id = argv[:9], (argv[9] if len(argv) > 9 else None)
    reshard = len(argv) > 10 and argv[10] == "reshard"
    num_p, pid = _world(num_p, pid)
    _share_cores(num_p)
    from ..align.pipeline import AlignConfig

    m, s, mx, mn = (float(x) for x in insert.split(","))
    cfg = AlignConfig(
        batch_size=int(batch_size),
        insert_override=(m, s, int(mx), int(mn)),
        checkpoint=every is not None, resume=resume,
        checkpoint_every=int(every) if every is not None else 8,
    )
    init_distributed(num_processes=num_p, process_id=pid)
    outs = align_fastq_multihost(
        reference, fq1, fq2 or None, out_prefix, cfg,
        num_p, pid, exdir, run_id=run_id or None,
        reshard=reshard, device=device,
    )
    if outs is not None:
        print(json.dumps(outs))
    return 0


def main(argv: List[str]) -> int:
    if argv[:1] == ["var"]:
        return _var_worker_main(argv[1:])
    if argv[:1] == ["sv"]:
        return _sv_worker_main(argv[1:])
    if argv[:1] == ["align"]:
        return _worker_main(argv[1:])
    return _worker_main(argv)


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
