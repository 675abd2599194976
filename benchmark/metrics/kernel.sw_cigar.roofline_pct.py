"""``ssq_sw_cigar``'s share of its roofline over the traced job: the
least time of its launched work (``roofline.sw_cigar_ms`` at each
launch's shape and rows) over the device time of ``sw_cigar_kernel``."""

import torch

from benchmark import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "align_reads_per_s"
KERNEL = "sw_cigar_kernel"


def read(run):
    if not run.on_card:
        return None
    dev_s, n = run.trace.kernel_seconds(KERNEL)
    calls = run.launches.get(KERNEL, [])
    if not calls or n == 0 or dev_s <= 0:
        return None
    bound_ms = 0.0
    for (lanes, Lq), (_, Lr), qlen in calls:
        rows = int(torch.clamp(qlen.to(torch.int64), 1, Lq).sum())
        bound_ms += roofline.sw_cigar_ms(lanes, Lq, Lr, rows, run.clock_hz,
                                         run.n_sms)
    return 100.0 * bound_ms / 1e3 / dev_s
