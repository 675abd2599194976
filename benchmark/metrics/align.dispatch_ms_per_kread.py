"""The align pipeline's dispatching thread a thousand reads: its wall
time inside ``align.dispatch`` (``time.align.dispatch``), the step's
launches from the host copies of the reads to the fetch's start."""

LAYER = "align pipeline"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.align.dispatch")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
