"""The warm job's index load (``time.align.index_load``): the bwa index
read from disk and the k-mer hash index built and moved to the card, as
every process pays it."""

LAYER = "index load"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.warm.get("time.align.index_load")
