"""Kernel #6's share of its roofline, %."""

from hgnnbench import readers


def read(r):
    return readers.roofline(r, "fused_fp_coeff")
