"""The realign extract's BAM decode a thousand reads: BGZF inflate and
record parse (``time.realign.extract.decode``)."""

LAYER = "realign extract"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("time.realign.extract.decode")
    if s is None or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
