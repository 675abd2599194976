"""Device meshes of one process, and the sharded production alignment step.

Counterpart of speedseq_tpu/parallel/mesh.py.  A mesh is an ordered list
of ONE process's devices (repeats allowed: ``[cuda:0] * 2`` runs two
shards on one card, ``[cpu] * 8`` eight on the CPU); the multi-process
design shards work per process (parallel.multihost) and never puts
another process's devices in a mesh.

- ``distributed_fused_step`` splits a read batch on dim 0 and runs the
  production step (align.core.fused_align_packed) for each shard on its
  device, from one host thread per device, so launches to different
  cards overlap.  Each shard's outputs are those of the single-device
  step on its rows, so shard count never changes a record.
- The FM / k-mer indexes are replicated once per device (``replicate``).
- What the JAX mesh reduces over its interconnect (``psum`` of aligned
  reads, ``pmax`` of the cigar-overflow flag, the output all-gather) is
  a host reduction here, in fixed shard order: no float or tie is ever
  decided by an order the device picks.
- ``coordinate_reshard`` routes (key, payload) rows to the shard owning
  their genome range; each (src, dst) bucket is copied to dst's device.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..align.core import DEFAULT_DISTRO, fused_align_packed
from ..device import resolve_device


class Mesh:
    """An ordered tuple of one process's devices, all of one type, with a
    host thread per shard and the per-device replicas of ``replicate``."""

    def __init__(self, devices: Sequence):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mixed device types in a mesh: {devs}")
        self.devices = devs
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._replicas: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def map(self, fn, *per_shard):
        """[fn(shard, device, *args of that shard) for each shard], each
        shard on its own host thread (its device current), results in
        shard order; the first shard's exception is raised."""
        n = self.size
        for a in per_shard:
            assert len(a) == n, (len(a), n)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="ssq-mesh")
        def run(s):
            dev = self.devices[s]
            args = [a[s] for a in per_shard]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fn(s, dev, *args)
            return fn(s, dev, *args)
        if n == 1:
            return [run(0)]
        futs = [self._pool.submit(run, s) for s in range(n)]
        return [f.result() for f in futs]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh of this process's devices: ``devices`` as given (repeats
    allowed), else every visible card (``cuda:0 .. cuda:{n-1}``); the CPU
    only when the caller names it.  ``n_devices`` keeps the first n."""
    if devices is None:
        resolve_device("cuda")          # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def _to(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):        # NamedTuple
        return type(x)(*(_to(f, dev) for f in x))
    return x


def replicate(mesh: Mesh, tree) -> list:
    """Per-shard copies of ``tree`` (a tensor or a NamedTuple of tensors:
    the FM or k-mer index): one copy per distinct device, cached on the
    mesh for as long as the mesh lives (so for trees that live as long),
    and ``tree`` itself where it already lives there."""
    if tree is None:
        return [None] * mesh.size
    out = []
    for dev in mesh.devices:
        key = (id(tree), str(dev))
        with mesh._lock:
            hit = mesh._replicas.get(key)
            if hit is None or hit[0] is not tree:
                hit = (tree, _to(tree, dev))
                mesh._replicas[key] = hit
        out.append(hit[1])
    return out


def shard_batch(mesh: Mesh, *arrays):
    """Split each array (numpy or tensor) on dim 0 into ``mesh.size``
    equal shards, shard s on device s; one list of shards per array."""
    n = mesh.size
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        assert t.shape[0] % n == 0, (
            f"batch {t.shape[0]} not divisible by mesh size {n}")
        b = t.shape[0] // n
        out.append([t[s * b:(s + 1) * b].to(dev)
                    for s, dev in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def distributed_fused_step(
    mesh: Mesh,
    fm,
    reads1,
    lengths1,
    reads2=None,
    lengths2=None,
    distro=None,
    kidx=None,
    n_chains: int = 4,
    min_seed_len: int = 19,
    **kw,
):
    """One data-parallel production alignment step over the mesh.

    The batch (numpy or tensors; its size a multiple of the mesh size) is
    split on dim 0; the indexes and the distro are replicated.  Returns
    (meta, cigar16, cigar, overflow, stats, xa_meta, xa_cig, n_aligned)
    in the packed layout of ``fused_align_packed``, gathered in shard
    order on the mesh's first device: XA read rows rebased by
    ``shard * B_local``, ``overflow`` the max over shards and
    ``n_aligned`` (a Python int) the sum, both taken on the host."""
    paired = reads2 is not None
    if distro is None:
        distro = torch.tensor(DEFAULT_DISTRO, dtype=torch.float32)
    ins = [shard_batch(mesh, a) for a in (reads1, lengths1, reads2, lengths2)
           if a is not None]
    fms = replicate(mesh, fm)
    kidxs = replicate(mesh, kidx)
    distro = torch.as_tensor(distro, dtype=torch.float32)

    def one(s, dev, *args):
        r1, l1 = args[0], args[1]
        r2, l2 = (args[2], args[3]) if paired else (None, None)
        meta, cig16, cig, ovf, stats, xam, xac = fused_align_packed(
            fms[s], r1, l1, r2, l2, distro=distro.to(dev), n_chains=n_chains,
            min_seed_len=min_seed_len, paired=paired, kidx=kidxs[s], **kw)
        ri = xam[:, 0]
        xam[:, 0] = torch.where(ri >= 0, ri + s * r1.shape[0], -1)
        n_al = int(((meta[:, 3, :, 0] & 0xFFFF) >= 30).sum())
        return (meta, cig16, cig, stats, xam, xac), int(ovf), n_al

    res = mesh.map(one, *ins)
    dev0 = mesh.devices[0]
    # batch axes of meta, cig16, cigar, stats, xa_meta, xa_cig
    axes = (2, 1, 1, 2, 2, 1)
    meta, cig16, cig, stats, xam, xac = (
        torch.cat([r[0][k].to(dev0) for r in res], dim=ax)
        for k, ax in enumerate(axes))
    overflow = torch.tensor(max(r[1] for r in res), dtype=torch.int32,
                            device=dev0)
    n_aligned = sum(r[2] for r in res)
    return meta, cig16, cig, overflow, stats, xam, xac, n_aligned


# ---------------------------------------------------------------------------
# coordinate re-shard: rows to their genome-range owner shard
# ---------------------------------------------------------------------------

KEY_SENTINEL = np.int64(2 ** 62)


def coordinate_reshard(
    mesh: Mesh,
    keys,                # (n_dev, n_local) int64 sort keys, SENTINEL pad
    rows,                # (n_dev, n_local, W) int64 payload columns
    boundaries,          # (n_dev - 1,) int64 range upper bounds
    cap: Optional[int] = None,
):
    """All-to-all re-shard of (key, payload-row) pairs to their genome-
    range owner shard.  Each shard routes its rows on its device (range
    by searchsorted, stable sort by target, per-target rank, scatter of
    the first ``cap`` rows of each target into its bucket); each (src,
    dst) bucket is then copied to dst's device.

    Returns (recv_keys (n_dev, n_dev, cap), recv_rows (..., W),
    recv_counts (n_dev, n_dev), dropped (n_dev, n_dev)) on the mesh's
    first device: entry [d, p] of the first three is what shard d
    received from shard p, in p's intake order; dropped[p, d] counts the
    rows of bucket (src p, dst d) beyond ``cap``, which the bucket could
    not hold (the JAX reshard loses them without a count)."""
    n_dev = mesh.size
    keys = torch.as_tensor(np.asarray(keys, np.int64))
    rows = torch.as_tensor(np.asarray(rows, np.int64))
    assert keys.shape[0] == n_dev and rows.shape[:2] == keys.shape
    n_local, W = keys.shape[1], rows.shape[2]
    cap = n_local if cap is None else int(cap)
    bounds = torch.as_tensor(np.asarray(boundaries, np.int64))

    def route(s, dev, k, r):
        k, r = k.to(dev), r.to(dev)
        tgt = torch.searchsorted(bounds.to(dev), k, right=True)
        tgt = torch.where(k < int(KEY_SENTINEL), tgt, n_dev)
        order = torch.argsort(tgt, stable=True)
        tgt_s = tgt[order]
        counts = torch.bincount(tgt_s, minlength=n_dev + 1)[:n_dev]
        starts = torch.cumsum(counts, 0) - counts
        rank = (torch.arange(n_local, device=dev)
                - starts[tgt_s.clamp_max(n_dev - 1)])
        ok = (tgt_s < n_dev) & (rank < cap)
        send_k = torch.full((n_dev, cap), int(KEY_SENTINEL),
                            dtype=torch.int64, device=dev)
        send_r = torch.zeros((n_dev, cap, W), dtype=torch.int64, device=dev)
        send_k[tgt_s[ok], rank[ok]] = k[order][ok]
        send_r[tgt_s[ok], rank[ok]] = r[order][ok]
        kept = counts.clamp_max(cap)
        return send_k, send_r, kept, counts - kept

    sent = mesh.map(route, list(keys), list(rows))

    def receive(d, dev):
        return (torch.stack([sent[p][0][d].to(dev) for p in range(n_dev)]),
                torch.stack([sent[p][1][d].to(dev) for p in range(n_dev)]),
                torch.stack([sent[p][2][d].to(dev) for p in range(n_dev)]))

    got = mesh.map(receive)
    dev0 = mesh.devices[0]
    recv_k = torch.stack([g[0].to(dev0) for g in got])
    recv_r = torch.stack([g[1].to(dev0) for g in got])
    recv_c = torch.stack([g[2].to(dev0) for g in got]).to(torch.int32)
    dropped = torch.stack([s[3].to(dev0) for s in sent]).to(torch.int32)
    return recv_k, recv_r, recv_c, dropped
