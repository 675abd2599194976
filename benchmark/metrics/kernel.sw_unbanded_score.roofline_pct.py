"""``ssq_sw_unbanded_score``'s share of its roofline over the traced job:
the least time of its launched work (``roofline.sw_unbanded_score_ms``)
over the device time of ``sw_unbanded_scan_kernel``."""

import torch

from benchmark import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "call_mbp_per_s"
KERNEL = "sw_unbanded_scan_kernel"


def read(run):
    if not run.on_card:
        return None
    dev_s, n = run.trace.kernel_seconds(KERNEL)
    calls = run.launches.get(KERNEL, [])
    if not calls or n == 0 or dev_s <= 0:
        return None
    bound_ms = 0.0
    for (lanes, Lq), (_, Lr), qlen in calls:
        rows = int(torch.clamp(qlen.to(torch.int64), 0, Lq).sum())
        bound_ms += roofline.sw_unbanded_score_ms(lanes, Lq, Lr, rows,
                                                  run.clock_hz, run.n_sms)
    return 100.0 * bound_ms / 1e3 / dev_s
