"""The realign extract a thousand reads: the lane BAMs' decode, the mate
pairing and the padded batches, on the align pipeline's prefetch thread
(``time.realign.extract``)."""

LAYER = "realign extract"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.realign.extract")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
