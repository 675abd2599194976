"""var's candidate loci a Mbp called, the haplotype scan inside
(``time.var.loci``)."""

LAYER = "var loci"
UNIT = "s/Mbp"
MOVES = "call_mbp_per_s"


def read(run):
    s = run.snap.get("time.var.loci")
    if s is None or not run.units:
        return None
    return s / run.units
