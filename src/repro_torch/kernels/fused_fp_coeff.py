"""Feature projection fused with the attention coefficients (kernel #6),
the counterpart of ``repro.kernels.fused_fp_coeff`` (paper Alg. 2 lines
7-8, §4.1.1 (1)):

    h = x @ w + b                               in float32
    theta_src[n, hd] = <h[n, hd], a_src[hd]>    per head, from the float32 h
    theta_dst[n, hd] = <h[n, hd], a_dst[hd]>

h is returned in x's dtype ``[N, H·Dh]``, both thetas in float32
``[N, H]``.  All five operands share one dtype, float32 or bfloat16.

:func:`fused_fp_coeff` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/fused_fp_coeff.cu``; CPU tensors take
:func:`fused_fp_coeff_plain`, the plain PyTorch version of the same
function and the oracle the kernel is held against.  Like the JAX
package's kernel it has no gradient.  It takes any N and Din: the
reference's ``block_n``/``block_k`` divisibility belongs to its TPU tiling
(the kernel tiles by its own constants), so the port drops those
arguments.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "fused_fp_coeff"
HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel is instantiated for these Dh
_DTYPES = (torch.float32, torch.bfloat16)


def fused_fp_coeff_plain(x, w, b, a_src, a_dst):
    """Plain PyTorch version of the kernel: ``x @ w + b`` on the upcast
    operands in float32, both thetas from that float32 h (as the Pallas
    kernel takes them, before the cast), then h cast to x's dtype."""
    heads, head_dim = a_src.shape
    h = x.float() @ w.float() + b.float()
    hh = h.reshape(x.shape[0], heads, head_dim)
    th_s = torch.einsum("nhd,hd->nh", hh, a_src.float())
    th_d = torch.einsum("nhd,hd->nh", hh, a_dst.float())
    return h.to(x.dtype), th_s, th_d


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.fused_fp_coeff_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(x, w, b, a_src, a_dst, h, theta_src, theta_dst) -> None:
    """Launch the CUDA kernel on checked operands into ``h``, ``theta_src``
    and ``theta_dst``, on the current stream.  Counts one launch."""
    N, K = x.shape
    H, Dh = a_src.shape
    lib, fn = _kernel_fn()
    p = build.ptr
    with torch.cuda.device(x.device):
        err = fn(p(x), p(w), p(b), p(a_src), p(a_dst), p(h), p(theta_src), p(theta_dst),
                 N, K, H, Dh, int(x.dtype == torch.bfloat16), build.stream_of(x))
    build.check_error(lib, _NAME, err)
    fused_fp_coeff.launches += 1


def fused_fp_coeff(
    x: torch.Tensor,      # [N, Din]     float32 or bfloat16
    w: torch.Tensor,      # [Din, H·Dh]  same dtype
    b: torch.Tensor,      # [H·Dh]       same dtype
    a_src: torch.Tensor,  # [H, Dh]      same dtype
    a_dst: torch.Tensor,  # [H, Dh]      same dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(h [N, H·Dh] in x's dtype, theta_src [N, H], theta_dst [N, H])``.

    CUDA operands launch the kernel; CPU operands take the plain version.
    Dh must be one of ``HEAD_DIMS``.  No gradient."""
    operands = (x, w, b, a_src, a_dst)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in operands):
        raise NotImplementedError(
            "fused_fp_coeff (kernel #6, the KERNEL backend's FP+theta) has no gradient, like "
            "the JAX package's Pallas kernel: train through NABackend.MULTIGRAPH or BLOCK")
    if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES:
        raise TypeError(f"x: expected a float32 or bfloat16 tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    dev, dt = x.device, x.dtype
    build.check_tensor("x", x, dt, (None, None), dev)
    N, K = x.shape
    build.check_tensor("a_src", a_src, dt, (None, None), dev)
    H, Dh = a_src.shape
    build.check_tensor("a_dst", a_dst, dt, (H, Dh), dev)
    build.check_tensor("w", w, dt, (K, None), dev)
    if w.shape[1] != H * Dh:
        raise ValueError(f"w has {w.shape[1]} columns, a_src's heads need H·Dh = {H}·{Dh}")
    build.check_tensor("b", b, dt, (H * Dh,), dev)
    if min(N, K, H) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, a_src {tuple(a_src.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {Dh} not in {HEAD_DIMS}")
    if dev.type == "cpu":
        return fused_fp_coeff_plain(x, w, b, a_src, a_dst)
    if dev.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    h = torch.empty((N, H * Dh), dtype=dt, device=dev)
    theta_src = torch.empty((N, H), dtype=torch.float32, device=dev)
    theta_dst = torch.empty((N, H), dtype=torch.float32, device=dev)
    launch(x, w, b, a_src, a_dst, h, theta_src, theta_dst)
    return h, theta_src, theta_dst


fused_fp_coeff.launches = 0
