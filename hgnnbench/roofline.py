"""The least time the H100 needs for a kernel's work, from the operations
and bytes the algorithm needs (counted from edges, heads and widths, so
the count is the same whatever implements it), and the chip's peaks.

Conventions: a multiply-add is 2 operations, an exp or a compare 1; each
input byte is read once and each output byte written once; ids are int32
and values float32.  An edge list is one src id an edge plus one offset a
dst row (CSR).  The least time is the larger of operations over the peak
and bytes over the memory bandwidth.

Peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit): HBM3 3.35
TB/s; float32 at full accuracy 494.7 / 3 TFLOP/s, the rate of a product
split into three TF32 products on the tensor cores (kernel #6 computes so,
and a float32 product need not be slower): the 67 TFLOP/s of the CUDA
cores is not a bound on float32 work.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 494.7e12 / 3}
F32 = 4
I32 = 4


def least_seconds(flops: float, nbytes: float, precision: str = "float32") -> float:
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def na_forward(edges: int, n_src: int, n_dst: int, graphs: int, heads: int, dh: int,
               *, lse: bool) -> tuple[float, float]:
    """Attention NA of ``graphs`` semantic graphs in one launch over one
    shared src table (kernels #1 and, with ``lse=False``, #5): (flops,
    bytes).  Per edge and head: the logit (2 adds, LeakyReLU 1), exp 1,
    the running sum 1 and the weighted row 2·Dh; per dst row and head one
    divide a column."""
    flops = edges * heads * (2 * dh + 5) + graphs * n_dst * heads * dh
    read = (graphs * (n_src + n_dst) * heads + n_src * heads * dh) * F32 \
        + (edges + graphs * n_dst) * I32
    write = graphs * n_dst * heads * (dh + (1 if lse else 0)) * F32
    return float(flops), float(read + write)


def na_backward(edges: int, n_src: int, n_dst: int, graphs: int, heads: int,
                dh: int) -> tuple[float, float]:
    """The NA's backward (kernel #2): (flops, bytes).  Per edge and head:
    the logit and p again (5), <g_out, h_src> 2·Dh, dp's softmax term 2,
    LeakyReLU's slope 1, d_h_src += p g_out 2·Dh, d_theta sums 2.  Reads
    theta, h_src, g_out, lse and delta (= <g_out, out>), writes d_theta_src,
    d_theta_dst and d_h_src."""
    flops = edges * heads * (4 * dh + 10)
    read = (graphs * (n_src + n_dst) * heads + n_src * heads * dh
            + graphs * n_dst * heads * (dh + 2)) * F32 + (edges + graphs * n_dst) * I32
    write = (graphs * (n_src + n_dst) * heads + n_src * heads * dh) * F32
    return float(flops), float(read + write)


def fp_coeff(n: int, k: int, heads: int, dh: int) -> tuple[float, float]:
    """FP fused with the attention coefficients (kernel #6): h = x W + b,
    theta_src and theta_dst = <h, a> a head: (flops, bytes)."""
    c = heads * dh
    flops = 2 * n * k * c + n * c + 4 * n * c
    read = (n * k + k * c + c + 2 * c) * F32
    write = (n * c + 2 * n * heads) * F32
    return float(flops), float(read + write)


def gemm(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n
