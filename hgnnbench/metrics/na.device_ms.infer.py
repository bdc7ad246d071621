"""Device ms a forward of kernel #5 (the NA)."""

from hgnnbench import readers


def read(r):
    return readers.device_ms(r, "infer", ("seg_gat_agg",))
