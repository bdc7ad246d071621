"""The joint #2's share of its roofline, % (its work counted by
``reference.simple_hgn.na_joint_backward``)."""

from hgnnbench import readers


def read(r):
    return readers.roofline(r, "seg_gat_agg_multigraph_bwd")
