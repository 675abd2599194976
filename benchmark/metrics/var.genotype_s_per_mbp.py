"""var's genotyping program a Mbp called (``time.var.genotype``)."""

LAYER = "genotyping"
UNIT = "s/Mbp"
MOVES = "call_mbp_per_s"


def read(run):
    s = run.snap.get("time.var.genotype")
    if s is None or not run.units:
        return None
    return s / run.units
