"""The align device step's stream span a thousand reads: the CUDA events
the pipeline records around each batch's ``fused_align_leaves``
(``align.device_step_s``), launch gaps included, so a span and not busy
time."""

LAYER = "align device step"
UNIT = "ms/kread"
MOVES = "align_reads_per_s"


def read(run):
    s = run.snap.get("align.device_step_s")
    if not run.on_card or not s or not run.units:
        return None
    return s * 1e3 / (run.units / 1e3)
