"""Device ms a step of the joint #1 and #2 (Simple-HGN's NA forward and
backward, `multigraph_fwd_kernel_joint`, `edge_pass_a_joint`, `edge_pass_b`)."""

from hgnnbench import readers


def read(r):
    return readers.device_ms(r, "train", ("seg_gat_agg_multigraph", "seg_gat_agg_multigraph_bwd"))
