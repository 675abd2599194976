"""The share of the traced align job in which no kernel, copy or set ran
on the card."""

LAYER = "device"
UNIT = "%"
MOVES = "align_reads_per_s"


def read(run):
    if not run.on_card or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
