"""The align device step's ``extend`` stage a thousand reads: each end's
extension of its chosen slots, as a stream span between the CUDA events
the step records at its stage boundaries
(``align.stage.extend.stream_s``), launch gaps included."""

LAYER = "align device step"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("align.stage.extend.stream_s")
    if not run.on_card or not s or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
