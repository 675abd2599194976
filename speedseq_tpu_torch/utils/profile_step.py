"""Where the device step's time goes, on the card.

    python -m speedseq_tpu_torch.utils.profile_step [--seed 0]

Builds the synthetic ~6 Mbp genome of chip_smoke.py, simulates one batch of
8,192 150 bp pairs (chip_smoke's batch) and runs the port's device step
(core.fused_align_leaves) on cuda.  Prints JSON lines:

  step      the step's time by CUDA events (mean of 3 warm steps)
  stages    the program's own spans of the step's five stages
            (core.stage_marks; ``align.stage.<s>`` in utils/metrics.py)
            over one step: each stage's stream time between its CUDA
            events, its host wall time and its thread CPU time
  profile   torch.profiler over one step: device kernel time summed, the
            step's wall time under the profiler, the device's idle share
            (against that wall and against the unprofiled step time), the
            top kernels by time

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from collections import defaultdict

import numpy as np
import torch

GENOME = (2_500_000, 2_000_000, 1_500_000)   # chip_smoke.py's genome
PAIRS = 8_192                      # chip_smoke.py's align batch
TOP = 15                           # kernels listed by time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from ..align import core
    from ..align.pipeline import _load_fm
    from ..device import resolve_device
    from . import synth
    from .metrics import metrics

    dev = resolve_device("cuda")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    work = os.path.join(root, "build", "profile_step")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        g = synth.make_genome(GENOME, seed=args.seed, n_del=64)
        fa = os.path.join(work, "genome.fa")
        synth.write_fasta(fa, g)
        idx, fm, kidx = _load_fm(fa, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rd = synth.simulate(g, PAIRS, read_len=150, seed=args.seed,
                        kill_frac=0.01)
    L = 151
    ins = []
    for s in (rd.seq1, rd.seq2):
        x = np.full((PAIRS, L), 4, np.uint8)
        x[:, :150] = s
        ins += [torch.from_numpy(x).to(dev),
                torch.full((PAIRS,), 150, dtype=torch.int32, device=dev)]
    distro = torch.tensor([320.0, 50.0, 120.0, 520.0], device=dev)

    def step():
        return core.fused_align_leaves(fm, *ins, distro=distro, kidx=kidx)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(3):
        step()
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / 3
    print(json.dumps({"phase": "step", "pairs": PAIRS, "read_len": 150,
                      "step_ms": step_ms,
                      "reads_per_s": 2 * PAIRS / step_ms * 1e3}),
          flush=True)

    before = metrics.snapshot()
    with core.stage_marks(
            lambda: torch.cuda.Event(enable_timing=True)) as marks:
        step()
    torch.cuda.synchronize()
    after = metrics.snapshot()
    spent = lambda kind: {
        k[len(kind) + len("align.stage."):]: (v - before.get(k, 0.0)) * 1e3
        for k, v in after.items() if k.startswith(kind + "align.stage.")}
    stream = marks.seconds()
    print(json.dumps({
        "phase": "stages",
        "stream_ms": {k: v * 1e3 for k, v in stream.items()},
        "stream_ms_total": sum(stream.values()) * 1e3,
        "host_ms": spent("time."), "cpu_ms": spent("cpu.")}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (each kernel once; the aten ops that launch
    # them carry the same time as "self device" and are skipped)
    from torch.autograd import DeviceType

    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if getattr(evt, "device_type", None) == DeviceType.CUDA:
            acc = per_kernel[evt.name]
            acc[0] += evt.time_range.elapsed_us() / 1e3
            acc[1] += 1
    rows = sorted(((v[0], v[1], k) for k, v in per_kernel.items()),
                  reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    print(json.dumps({
        "phase": "profile", "wall_ms": wall_ms, "kernel_ms": kernel_ms,
        "idle_share": (1.0 - kernel_ms / wall_ms) if kernel_ms else None,
        "idle_share_vs_step_ms": 1.0 - kernel_ms / step_ms,
        "n_kernel_kinds": len(rows),
        "n_launches": int(sum(r[1] for r in rows)),
        "top": [{"ms": r[0], "count": r[1], "name": r[2][:90]}
                for r in rows[:TOP]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
