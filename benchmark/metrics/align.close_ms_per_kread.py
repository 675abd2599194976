"""The align job's close after its last batch, a thousand reads: the
sorters' merge, the BGZF writes and the BAIs of the three BAMs
(``time.align.close``)."""

LAYER = "align close"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.align.close")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
