"""Mean host ms from a training step's call to its return, with no
synchronise."""

from hgnnbench import readers


def read(r):
    return readers.enqueue_ms(r, "train")
