"""Time the dispatching thread waits for the next batch of reads from the
FASTQ prefetch (``time.align.input_wait``), a thousand reads."""

LAYER = "align pipeline"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.align.input_wait")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
