"""Causal / local-window / bidirectional GQA attention forward (kernel #7),
the counterpart of ``repro.kernels.flash_attention``.

    q [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh]  ->  out [B, Hq, Sq, Dh]

Query head h reads KV head h // (Hq / Hkv).  Query row i sits at position
``i + Sk - Sq`` (the last query is aligned with the last key); key j is
visible to it when ``j <= qpos`` (``causal``) and ``j > qpos - window``
(``window``).  q is scaled in float32 before the product, scores and the
softmax statistics are float32, the output is ``acc / max(l, 1e-9)`` in
q's dtype: a row that sees no key gives exact zeros.  No logit soft cap,
as in the reference's flash path.

:func:`flash_attention` is the wrapper: CUDA tensors launch a
hand-written kernel of ``csrc/flash_attention.cu``; CPU tensors take
:func:`flash_attention_plain`, the dense masked softmax of the same
function and the oracle the kernels are held against.  Like the JAX
package's kernel it has no gradient.

Two kernels, one per :func:`route`, chosen from the dtype and head width
before the launch (neither stands in for the other):

* ``"wgmma"``: bf16 at Dh in {64, 128}, on the tensor cores.  q·kᵀ from
  the unscaled bf16 operands (each product exact in float32, summed in
  float32), the scale applied to the float32 score; p split into bf16
  ``p_hi + p_lo`` for p·v, so p keeps about 16 bits.  Its output is within
  one bf16 rounding of the float32 computation.
* ``"cuda_cores"``: float32 operands, and bf16 at the other widths, with
  float32 FMAs on q scaled before the product, as the reference does.

:func:`tensor_core_emulation` is the wgmma route's numerics in plain
PyTorch (split or single-rounded p), the control for the bitwise check
``BITWISE_SHARE_MIN``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .seg_gat_agg_multigraph import SMEM_OPTIN

_NAME = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the CUDA-core kernel is instantiated for these Dh
WGMMA_HEAD_DIMS = (64, 128)            # the tensor-core kernel's
ROUTES = ("wgmma", "cuda_cores")
# the kernels' tiles (csrc/flash_attention.cu)
BLOCK_Q = BLOCK_K = 64                 # cuda_cores
WGMMA_BLOCK_Q = WGMMA_BLOCK_K = 128    # wgmma
WGMMA_STAGES = 2                       # wgmma's K / V ring
_DTYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, Dh: int) -> str:
    """Which kernel takes operands of ``dtype`` and head width ``Dh`` on the
    card: ``"wgmma"`` (bf16 tensor cores) for bfloat16 at Dh in
    ``WGMMA_HEAD_DIMS``, else ``"cuda_cores"``."""
    return "wgmma" if dtype == torch.bfloat16 and Dh in WGMMA_HEAD_DIMS else "cuda_cores"


def attention_mask(sq: int, sk: int, causal: bool, window: int | None,
                   device: torch.device) -> torch.Tensor:
    """bool [Sq, Sk]: which keys each query row sees."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the dense masked softmax in
    float32 on the upcast operands, out in q's dtype."""
    hq, dh = q.shape[1], q.shape[-1]
    group = hq // k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    s = (q.float() * scale) @ kf.transpose(-1, -2)
    s.masked_fill_(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p.masked_fill_(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vf) / torch.clamp_min(l, 1e-9)).to(q.dtype)


# Share of bf16 outputs of the wgmma route that must equal the one rounding
# of the float32 result (flash_attention_plain) bitwise.  The emulation
# below passes it with p split and fails it with p rounded once to bf16
# (tests/test_torch_lm_kernel.py asserts both at the sweep's shapes,
# chip_smoke.py at llama3.2-3b's layer), so a kernel that drops or
# misplaces p_lo fails it.
BITWISE_SHARE_MIN = 0.95


def tensor_core_emulation(q, k, v, *, causal: bool, window: int | None,
                          block_k: int = WGMMA_BLOCK_K, split: bool = True) -> torch.Tensor:
    """The wgmma route's numerics in plain PyTorch, float32 out before the
    final cast: q·kᵀ of the unscaled bf16 operands (each product exact in
    float32, summed in float32) times the scale; an online float32 softmax
    over key tiles of ``block_k``, masked scores at -inf, m from -1e30; p·v
    as ``p_hi·v + p_lo·v`` with ``p_hi = bf16(p)``, ``p_lo = bf16(p -
    p_hi)`` (``split=False``: ``bf16(p)·v``, one rounding of p)."""
    B, Hq, Sq, Dh = q.shape
    Sk = k.shape[2]
    group = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq), device=q.device)
    acc = torch.zeros((B, Hq, Sq, Dh), device=q.device)
    for j0 in range(0, Sk, block_k):
        s = (qf @ kf[..., j0:j0 + block_k, :].transpose(-1, -2)) * Dh ** -0.5
        s.masked_fill_(~mask[:, j0:j0 + block_k], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.bfloat16().float()
        vt = vf[..., j0:j0 + block_k, :]
        pv = p_hi @ vt + (p - p_hi).bfloat16().float() @ vt if split else p_hi @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-9)[..., None]


def smem_bytes(Dh: int, route: str) -> int:
    """Dynamic shared memory of one block of ``route``'s kernel (mirrors the
    .cu layouts).  cuda_cores: q transposed [Dh][BQ+4], the K (transposed)
    / V tile [Dh][BK+4] and p transposed [BK][BQ+4], all float32.  wgmma:
    the bf16 Q tile [BQ][Dh], a ring of ``WGMMA_STAGES`` K and V tiles
    [BK][Dh], one mbarrier for Q and three a stage, and 1,024 B to align
    the swizzled tiles."""
    if route == "wgmma":
        return (2 * Dh * (WGMMA_BLOCK_Q + 2 * WGMMA_STAGES * WGMMA_BLOCK_K)
                + 8 * (1 + 3 * WGMMA_STAGES) + 1024)
    if route != "cuda_cores":
        raise ValueError(f"unknown route {route!r}: one of {ROUTES}")
    return 4 * (Dh * (BLOCK_Q + 4) + Dh * (BLOCK_K + 4) + BLOCK_K * (BLOCK_Q + 4))


def card_route(dtype: torch.dtype, Dh: int) -> str:
    """:func:`route` for operands on the card, after the checks the kernel
    needs: Dh is instantiated, and the route's block fits in shared memory."""
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {Dh} not in {HEAD_DIMS}")
    route_ = route(dtype, Dh)
    need = smem_bytes(Dh, route_)
    if need > SMEM_OPTIN:
        raise ValueError(f"{_NAME}: Dh={Dh} on the {route_} route needs {need} B of shared "
                         f"memory per block, more than the {SMEM_OPTIN} B a block can have")
    return route_


def _kernel_fn(route_: str):
    lib = build.load(_NAME)
    if route_ == "wgmma":
        fn = lib.flash_attention_wgmma_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def launch(q, k, v, out, *, causal: bool, window: int | None, scale: float) -> None:
    """Launch the kernel of :func:`route` on checked operands into ``out``,
    on the current stream.  Counts one launch, in total and by route."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    route_ = route(q.dtype, Dh)
    lib, fn = _kernel_fn(route_)
    p = build.ptr
    args = [p(q), p(k), p(v), p(out), B, Hq, Hkv, Sq, Sk, Dh, int(causal),
            int(window is not None), int(window or 0), float(scale)]
    if route_ == "cuda_cores":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        err = fn(*args, build.stream_of(q))
    build.check_error(lib, _NAME, err)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route_] += 1


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, Dh]   float32 or bfloat16
    k: torch.Tensor,  # [B, Hkv, Sk, Dh]  same dtype
    v: torch.Tensor,  # [B, Hkv, Sk, Dh]  same dtype
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Attention out ``[B, Hq, Sq, Dh]`` in q's dtype.

    CUDA operands launch the kernel; CPU operands take the plain version.
    ``block_q``/``block_k`` are the reference's tiles: they set only the
    shape precondition it has (``Sq % min(block_q, Sq) == 0``, the same for
    Sk), so both packages accept the same inputs; the kernels tile by 64
    (cuda_cores) or 128 (wgmma).
    No gradient."""
    dev = q.device
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention (kernel #7) has no gradient, like the JAX package's Pallas kernel "
            "(no custom_vjp): LM training runs impl=\"xla\", as the reference's does")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    build.check_tensor("q", q, q.dtype, (None, None, None, None), dev)
    B, Hq, Sq, Dh = q.shape
    build.check_tensor("k", k, q.dtype, (B, None, None, Dh), dev)
    Hkv, Sk = k.shape[1], k.shape[2]
    build.check_tensor("v", v, q.dtype, (B, Hkv, Sk, Dh), dev)
    if min(B, Hq, Sq, Dh, Hkv, Sk) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of the blocks "
                         f"min(block_q, Sq)={bq} and min(block_k, Sk)={bk}")
    scale = scale if scale is not None else Dh ** -0.5
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    if card_route(q.dtype, Dh) == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{_NAME}: the tensor-core route loads q, k and v by TMA, which needs "
                         "16-byte aligned base addresses")
    out = torch.empty_like(q)
    launch(q, k, v, out, causal=causal, window=window, scale=scale)
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
