"""The dispatching thread's CPU time inside ``align.dispatch`` a thousand
reads (``cpu.align.dispatch``): set against the wall time of the same
span, the rest is the time the thread waited (the GIL, a full launch
queue)."""

LAYER = "align pipeline"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("cpu.align.dispatch")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
