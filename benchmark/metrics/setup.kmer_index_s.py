"""The warm job's k-mer hash index build on the host
(``time.align.index_load.kmer``), part of the index load that every
process pays."""

LAYER = "index load"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.warm.get("time.align.index_load.kmer")
