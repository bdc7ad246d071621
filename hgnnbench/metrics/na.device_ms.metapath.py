"""Device ms a step of kernels #1 and #2 (the NA forward and backward)."""

from hgnnbench import readers


def read(r):
    return readers.device_ms(r, "train", ("seg_gat_agg_multigraph", "seg_gat_agg_multigraph_bwd"))
