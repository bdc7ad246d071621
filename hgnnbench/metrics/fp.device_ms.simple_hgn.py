"""Device ms a step of the library's matrix products (FP, theta, fusion and
classifier products, forward and backward)."""

from hgnnbench import readers


def read(r):
    return readers.device_ms(r, "train", gemm=True)
