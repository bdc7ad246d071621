"""Device ms a forward of kernel #6 (FP fused with theta)."""

from hgnnbench import readers


def read(r):
    return readers.device_ms(r, "infer", ("fused_fp_coeff",))
