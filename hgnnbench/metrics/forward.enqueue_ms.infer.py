"""Mean host ms from a forward's call to its return, before its
synchronise."""

from hgnnbench import readers


def read(r):
    return readers.enqueue_ms(r, "infer")
