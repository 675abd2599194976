"""The seconds of set-up spent aligning the cell's input BAMs through the
program's ``align`` (``sample.align``): part of ``setup_s`` that the
caller cells pay for their inputs, not for calling."""

LAYER = "set-up inputs"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.setup.get("inputs_align")
