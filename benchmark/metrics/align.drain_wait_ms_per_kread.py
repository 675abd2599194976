"""Time the dispatching thread waits on the host epilogue's bounded
look-ahead, and for the last batches' epilogue
(``time.align.drain_wait``), a thousand reads."""

LAYER = "align pipeline"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.align.drain_wait")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
