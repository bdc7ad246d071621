"""Feature projection fused with the attention coefficients (kernel #6),
the counterpart of ``repro.kernels.fused_fp_coeff`` (paper Alg. 2 lines
7-8, §4.1.1 (1)):

    h = x @ w + b                               in float32
    theta_src[n, hd] = <h[n, hd], a_src[hd]>    per head, from the float32 h
    theta_dst[n, hd] = <h[n, hd], a_dst[hd]>

h is returned in x's dtype ``[N, H·Dh]``, both thetas in float32
``[N, H]``.  All five operands share one dtype, float32 or bfloat16.

:func:`fused_fp_coeff` is the wrapper: CUDA tensors launch a hand-written
kernel of ``csrc/fused_fp_coeff.cu``; CPU tensors take
:func:`fused_fp_coeff_plain`, the plain PyTorch version of the same
function and the oracle the kernels are held against.  Like the JAX
package's kernel it has no gradient.  It takes any N and Din: the
reference's ``block_n``/``block_k`` divisibility belongs to its TPU tiling
(the kernels tile by their own constants), so the port drops those
arguments.

Two kernels, one per :func:`route`, chosen from the dtype before the
launch (neither stands in for the other):

* ``"wgmma"``: float32, on the tensor cores by split TF32.  Each operand
  is cut into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` (both rounded to
  nearest, ties away), and three products ``x_hi w_hi + x_hi w_lo + x_lo
  w_hi`` go into one float32 accumulator; launches with few row tiles
  split K into :func:`split_k` slices, summed in slice order.
* ``"cuda_cores"``: bfloat16 (and float32 when :func:`launch` is asked for
  it), float32 FMAs on the CUDA cores.

:func:`tensor_core_emulation` is the wgmma route's numerics in plain
PyTorch (three products, or one TF32 product), the control for the limit
``SPLIT_ERROR_MAX`` on :func:`split_error`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "fused_fp_coeff"
HEAD_DIMS = (8, 16, 32, 64, 128)  # both kernels take these Dh
ROUTES = ("wgmma", "cuda_cores")
_DTYPES = (torch.float32, torch.bfloat16)
# the wgmma kernel's tiles (csrc/fused_fp_coeff.cu, namespace tc)
BLOCK_M, BLOCK_N, BLOCK_K = 128, 256, 16
SMS = 132                  # the H100 SXM's SMs, the card the split rule is sized for
MIN_SLICE_K_TILES = 32     # a K slice keeps at least 32 tiles of BLOCK_K (512 of Din)
CHAIN_TILES = 64           # K tiles one tensor-core accumulator runs before it is promoted


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


def route(dtype: torch.dtype, Dh: int) -> str:
    """Which kernel takes operands of ``dtype`` and head width ``Dh`` on the
    card: ``"wgmma"`` (split TF32 on the tensor cores) for float32 at every
    Dh in ``HEAD_DIMS`` (each divides the tile's 256 columns), else
    ``"cuda_cores"``."""
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {Dh} not in {HEAD_DIMS}")
    return "wgmma" if dtype == torch.float32 else "cuda_cores"


def split_k(N: int, Din: int, C: int) -> int:
    """Slices of the K axis on the wgmma route, a fixed rule of the shape:
    as many as keep the (row, column) tiles times slices within one wave of
    ``SMS`` blocks, each slice at least ``MIN_SLICE_K_TILES`` tiles deep;
    at least 1."""
    tiles = -(-N // BLOCK_M) * -(-C // BLOCK_N)
    k_tiles = -(-Din // BLOCK_K)
    return max(1, min(SMS // tiles, k_tiles // MIN_SLICE_K_TILES))


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# Limit on split_error for the wgmma route.  The emulation below passes it by
# more than 10x with the three-product split and fails it by more than 10x
# with one TF32 product, at Din = 3,341 (R-GAT's actor projection) and 256
# (tests/test_torch_kernel6.py); chip_smoke.py holds the kernel to it.
SPLIT_ERROR_MAX = 3e-6


def split_error(h, x, w, b) -> float:
    """``max |h - h64| / (|x|·|w| + |b|)`` over the entries of h, with h64 =
    x·w + b and the normaliser in float64: the usual scale of a GEMM's
    rounding error.  An entry whose normaliser is 0 counts 0 if exact."""
    h64 = x.double() @ w.double() + b.double()
    norm = x.double().abs() @ w.double().abs() + b.double().abs()
    diff = (h.double() - h64).abs()
    ratio = torch.where(norm > 0, diff / norm.clamp_min(1e-300),
                        torch.where(diff > 0, torch.inf, 0.0))
    return float(ratio.max())


def tensor_core_emulation(x, w, b, a_src, a_dst, *, split: bool = True,
                          splits: int | None = None):
    """The wgmma route's numerics in plain PyTorch on float32 operands:
    ``(h, theta_src, theta_dst)`` in float32.  Each k8 step adds its
    products to a float32 accumulator, each product exact and rounded once:
    ``x_hi w_hi``, ``x_hi w_lo``, ``x_lo w_hi`` (``split=False``: ``x_hi
    w_hi`` alone); K runs in ``splits`` slices of BLOCK_K tiles
    (:func:`split_k` by default), each in chains of ``CHAIN_TILES`` tiles
    (the others' sums added in order to the last one's), and the slices are
    summed in order; then
    the bias and both thetas from the float32 h.  (The tensor cores' own
    sums within a chain are not round-to-nearest, which this does not
    model.)"""
    N, K = x.shape
    heads, head_dim = a_src.shape
    C = heads * head_dim
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi), _tf32(w - w_hi)
    terms = [(x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi)] if split else [(x_hi, w_hi)]
    S = split_k(N, K, C) if splits is None else splits
    k_tiles = -(-K // BLOCK_K)
    total = None
    for z in range(S):
        k_begin, k_end = z * k_tiles // S * BLOCK_K, min((z + 1) * k_tiles // S * BLOCK_K, K)
        chains = []
        for c0 in range(k_begin, k_end, CHAIN_TILES * BLOCK_K):
            acc = torch.zeros((N, C), dtype=torch.float32, device=x.device)
            for k0 in range(c0, min(c0 + CHAIN_TILES * BLOCK_K, k_end), 8):
                for xa, wb in terms:
                    acc = acc + (xa[:, k0:k0 + 8].double() @ wb[k0:k0 + 8].double()).float()
            chains.append(acc)
        part = chains.pop()  # the last chain, then the others in order
        for acc in chains:
            part = part + acc
        total = part if total is None else total + part
    h = total + b.float()
    hh = h.reshape(N, heads, head_dim)
    return (h, torch.einsum("nhd,hd->nh", hh, a_src.float()),
            torch.einsum("nhd,hd->nh", hh, a_dst.float()))


def split_scratch(rows: int, K: int, C: int, T: int, S: int, device) -> tuple:
    """The wgmma route's scratch (``csrc/split_tf32_gemm.cuh``'s layout) for
    ``rows`` rows of x against ``T`` tables of w [K, C] in ``S`` K slices,
    in one float32 buffer: w's split [2, T·C, Kp] (Kp = K rounded up to 4),
    the slices' partials [S, rows, C], the chains' sums each slice stores
    before its last [S, M, rows, C], the row tiles' split-K tickets.
    Returns (the buffer, the four addresses); the buffer must stay
    referenced until the launch is enqueued."""
    n_wt = T * 2 * C * (-(-K // 4) * 4)
    n_part = S * rows * C if S > 1 else 0
    n_chain = S * ((-(-K // BLOCK_K // S) - 1) // CHAIN_TILES) * rows * C
    n_tickets = -(-rows // BLOCK_M) * -(-C // BLOCK_N) if S > 1 else 0
    scratch = torch.empty(n_wt + n_part + n_chain + n_tickets, dtype=torch.float32, device=device)
    at = scratch.data_ptr()
    return scratch, (at, at + 4 * n_wt, at + 4 * (n_wt + n_part),
                     at + 4 * (n_wt + n_part + n_chain))


def _kernel_fn(route_: str):
    lib = build.load(_NAME)
    if route_ == "wgmma":
        fn = lib.fused_fp_coeff_wgmma_fwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    else:
        fn = lib.fused_fp_coeff_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(x, w, b, a_src, a_dst, h, theta_src, theta_dst, *, route_: str | None = None) -> None:
    """Launch the kernel of ``route_`` (default :func:`route`) on checked
    operands into ``h``, ``theta_src`` and ``theta_dst``, on the current
    stream.  The wgmma route allocates its scratch here
    (:func:`split_scratch`).  Counts one launch, in total and by
    route."""
    N, K = x.shape
    H, Dh = a_src.shape
    route_ = route_ or route(x.dtype, Dh)
    if route_ not in ROUTES or (route_ == "wgmma" and x.dtype != torch.float32):
        raise ValueError(f"{_NAME}: route {route_!r} does not take {x.dtype}")
    lib, fn = _kernel_fn(route_)
    p, dev = build.ptr, x.device
    with torch.cuda.device(dev):
        if route_ == "wgmma":
            S = split_k(N, K, H * Dh)
            scratch, addresses = split_scratch(N, K, H * Dh, 1, S, dev)
            err = fn(p(x), p(w), p(b), p(a_src), p(a_dst), p(h), p(theta_src), p(theta_dst),
                     *addresses, N, K, H, Dh, S, build.stream_of(x))
        else:
            err = fn(p(x), p(w), p(b), p(a_src), p(a_dst), p(h), p(theta_src), p(theta_dst),
                     N, K, H, Dh, int(x.dtype == torch.bfloat16), build.stream_of(x))
    build.check_error(lib, _NAME, err)
    fused_fp_coeff.launches += 1
    fused_fp_coeff.launches_by_route[route_] += 1


def fused_fp_coeff(
    x: torch.Tensor,      # [N, Din]     float32 or bfloat16
    w: torch.Tensor,      # [Din, H·Dh]  same dtype
    b: torch.Tensor,      # [H·Dh]       same dtype
    a_src: torch.Tensor,  # [H, Dh]      same dtype
    a_dst: torch.Tensor,  # [H, Dh]      same dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(h [N, H·Dh] in x's dtype, theta_src [N, H], theta_dst [N, H])``.

    CUDA operands launch the kernel of :func:`route`; CPU operands take
    the plain version.
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
    route(dt, Dh)  # raises on a head width no kernel takes
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
fused_fp_coeff.launches_by_route = dict.fromkeys(ROUTES, 0)
