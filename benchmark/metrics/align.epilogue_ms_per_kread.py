"""The align host epilogue a thousand reads: record building, pairing,
duplicate marking and splitter/discordant selection
(``time.align.emit``) and the sorters' intake
(``time.align.sort_intake``)."""

LAYER = "align host epilogue"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    a = run.snap.get("time.align.emit")
    b = run.snap.get("time.align.sort_intake")
    if a is None or b is None or not run.units:
        return None
    return (a + b) * 1e3 / (run.units / 1e3)
