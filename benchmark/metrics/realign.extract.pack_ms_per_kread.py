"""The realign extract's packing a thousand reads: each read turned back
to its original orientation and copied into the padded batch arrays
(``time.realign.extract.pack``)."""

LAYER = "realign extract"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.realign.extract.pack")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
