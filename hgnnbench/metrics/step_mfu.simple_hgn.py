"""The whole training step's share of the float32 peak, %."""

from hgnnbench import readers


def read(r):
    return readers.mfu(r, "train")
