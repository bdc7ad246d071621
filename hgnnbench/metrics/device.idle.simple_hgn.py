"""Share of the traced window with no kernel, copy or fill on the card, %."""

from hgnnbench import readers


def read(r):
    return readers.idle(r, "train")
