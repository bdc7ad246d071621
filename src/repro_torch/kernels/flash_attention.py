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

:func:`flash_attention` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/flash_attention.cu``; CPU tensors take
:func:`flash_attention_plain`, the dense masked softmax of the same
function and the oracle the kernel is held against.  Like the JAX
package's kernel it has no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .seg_gat_agg_multigraph import SMEM_OPTIN

_NAME = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the kernel is instantiated for these Dh
BLOCK_Q = BLOCK_K = 64                 # the kernel's tiles (csrc/flash_attention.cu)
_DTYPES = (torch.float32, torch.bfloat16)


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


def smem_bytes(Dh: int) -> int:
    """Dynamic shared memory of one block (mirrors the .cu layout): q
    transposed [Dh][BQ+4], the K (transposed) / V tile [Dh][BK+4] and p
    transposed [BK][BQ+4], all float32."""
    return 4 * (Dh * (BLOCK_Q + 4) + Dh * (BLOCK_K + 4) + BLOCK_K * (BLOCK_Q + 4))


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def launch(q, k, v, out, *, causal: bool, window: int | None, scale: float) -> None:
    """Launch the CUDA kernel on checked operands into ``out``, on the
    current stream.  Counts one launch."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    lib, fn = _kernel_fn()
    p = build.ptr
    with torch.cuda.device(q.device):
        err = fn(p(q), p(k), p(v), p(out), B, Hq, Hkv, Sq, Sk, Dh, int(causal),
                 int(window is not None), int(window or 0), float(scale),
                 int(q.dtype == torch.bfloat16), build.stream_of(q))
    build.check_error(lib, _NAME, err)
    flash_attention.launches += 1


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
    Sk), so both packages accept the same inputs; the kernel tiles by 64.
    No gradient."""
    dev = q.device
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention (kernel #7) has no gradient, like the JAX package's Pallas kernel "
            "(no custom_vjp): LM training is ROADMAP Queue 1 item 7h")
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
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {Dh} not in {HEAD_DIMS}")
    if smem_bytes(Dh) > SMEM_OPTIN:
        raise ValueError(f"{_NAME}: Dh={Dh} needs {smem_bytes(Dh)} B of shared memory per "
                         f"block, more than the {SMEM_OPTIN} B a block can have")
    out = torch.empty_like(q)
    launch(q, k, v, out, causal=causal, window=window, scale=scale)
    return out


flash_attention.launches = 0
