"""Time the align pipeline's drain thread waits for a batch's results to
reach the host (``time.align.fetch_wait``), a thousand reads."""

LAYER = "align pipeline"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.align.fetch_wait")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
