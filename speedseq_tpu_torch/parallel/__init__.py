"""Parallel runs of the port: shards of one process, and processes.

- ``mesh``: a mesh is one process's devices (``make_mesh``); read batches
  are data-parallel over it through ``distributed_fused_step`` (the same
  device step as the single-device pipeline, align.core.
  fused_align_packed, so shard count never changes a record), the FM /
  k-mer indexes are replicated once per device, and per-shard counts
  reduce on the host in shard order.  var's genotyping and sv's SVTyper
  shard their site and call axes over a mesh too.
- ``multihost``: several processes (``python -m
  speedseq_tpu_torch.parallel.multihost align|var|sv ...``), each on its
  own card or sharing one, exchanging dup signatures, record parts and
  per-sample results over torch.distributed (gloo) or a shared
  directory.
"""

from .mesh import (  # noqa: F401
    Mesh,
    distributed_fused_step,
    make_mesh,
    replicate,
    shard_batch,
)
