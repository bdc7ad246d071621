"""Kernel #2's share of its roofline, %."""

from hgnnbench import readers


def read(r):
    return readers.roofline(r, "seg_gat_agg_multigraph_bwd")
