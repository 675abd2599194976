"""var's pileup a Mbp called: BAI fetch, native decode and the pileup
columns (``time.var.pileup``)."""

LAYER = "var pileup"
UNIT = "s/Mbp"
MOVES = "call_mbp_per_s"


def read(run):
    s = run.snap.get("time.var.pileup")
    if s is None or not run.units:
        return None
    return s / run.units
