"""GQA attention: RoPE, qk-norm, bias, windowing, KV cache, and the
encoder-decoder's cross-attention.

The counterpart of ``repro/models/lm/attention.py``, on one card (the
reference's ``shard`` annotations are no-ops without a mesh and are
dropped).  Two implementations of the full-sequence path with the same
semantics:

  * "xla"   — the plain einsum attention (``_sdpa_xla``), or from S = 8192 on
              the chunked online softmax (``_sdpa_flash_xla``), in PyTorch;
  * "flash" — kernel #7 (``kernels/flash_attention.py``): CUDA tensors
              launch the hand-written kernel, CPU tensors its plain version.

Where the reference mixes dtypes (a float32 query against bfloat16 caches,
or bfloat16 probabilities against float32 values), ``jnp.einsum`` promotes
and ``torch.einsum`` refuses: both operands are cast to
``torch.promote_types`` first, which is what JAX computes.

Decode writes the caches in place (the reference returns new arrays); the
returned ``AttnCache`` holds the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ...kernels.flash_attention import flash_attention
from .config import LMConfig
from .layers import P, apply_rope, rms_norm

NEG_INF = -1e30


def attention_specs(cfg: LMConfig, *, layers: int | None = None, cross: bool = False) -> dict:
    d = cfg.d_model
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    specs = {
        "wq": P(lead + (d, hq), lax_ + ("embed", "heads")),
        "wk": P(lead + (d, hkv), lax_ + ("embed", "kv_heads")),
        "wv": P(lead + (d, hkv), lax_ + ("embed", "kv_heads")),
        "wo": P(lead + (hq, d), lax_ + ("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        specs.update(
            bq=P(lead + (hq,), lax_ + ("heads",), init="zeros"),
            bk=P(lead + (hkv,), lax_ + ("kv_heads",), init="zeros"),
            bv=P(lead + (hkv,), lax_ + ("kv_heads",), init="zeros"),
        )
    if cfg.qk_norm and not cross:
        specs.update(
            q_norm=P(lead + (cfg.head_dim,), lax_ + (None,), init="ones"),
            k_norm=P(lead + (cfg.head_dim,), lax_ + (None,), init="ones"),
        )
    return specs


@dataclasses.dataclass
class AttnCache:
    """KV cache: full-context or ring-buffered (local attention)."""

    k: torch.Tensor    # [B, S_cache, Hkv, Dh]
    v: torch.Tensor    # [B, S_cache, Hkv, Dh]
    pos: torch.Tensor  # [B, S_cache] int32 absolute position of each slot (-1 empty)


def init_attn_cache(cfg: LMConfig, batch: int, cache_len: int, dtype,
                    device: torch.device | str) -> AttnCache:
    eff = min(cache_len, cfg.window) if cfg.window else cache_len
    return AttnCache(
        k=torch.zeros((batch, eff, cfg.num_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, eff, cfg.num_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        pos=torch.full((batch, eff), -1, dtype=torch.int32, device=device),
    )


def _project_qkv(params, x, cfg: LMConfig):
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _promoted(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _sdpa_xla(q, k, v, mask, cfg: LMConfig):
    """q [B,Sq,Hq,Dh], k/v [B,Sk,Hkv,Dh], mask [B,Sq,Sk] bool."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", *_promoted(qg, k)).float() * (dh ** -0.5)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", *_promoted(p, v))
    return out.reshape(b, sq, hq, dh)


def _sdpa_flash_xla(
    q, k, v, cfg: LMConfig, *, causal: bool, window: int | None,
    q_chunk: int = 1024, k_chunk: int = 2048,
):
    """Chunked online-softmax attention in plain PyTorch (the reference's
    long-context path): no S×S score tensor ever exists.  k chunks stream
    through a loop carrying (m, l, acc)."""
    b, s, hq, dh = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    group = hq // hkv
    qc = min(q_chunk, s)
    kc = min(k_chunk, sk)
    nq, nk = s // qc, sk // kc
    scale = dh ** -0.5
    dev = q.device
    qr = q.reshape(b, nq, qc, hkv, group, dh)
    kr = k.reshape(b, nk, kc, hkv, dh)
    vr = v.reshape(b, nk, kc, hkv, dh)
    qpos = (torch.arange(nq, device=dev)[:, None] * qc
            + torch.arange(qc, device=dev)[None, :]) + (sk - s)
    m_run = torch.full((b, nq, hkv, group, qc), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, nq, hkv, group, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, hkv, group, qc, dh), dtype=torch.float32, device=dev)
    for i in range(nk):
        kb, vb = kr[:, i], vr[:, i]
        sblk = torch.einsum("bnqhgd,bkhd->bnhgqk", qr, kb).float() * scale
        if cfg.logits_soft_cap:
            sblk = cfg.logits_soft_cap * torch.tanh(sblk / cfg.logits_soft_cap)
        kpos = i * kc + torch.arange(kc, device=dev)
        mask = torch.ones((nq, qc, kc), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, None, :] <= qpos[:, :, None]
        if window is not None:
            mask &= kpos[None, None, :] > qpos[:, :, None] - window
        mask6 = mask[None, :, None, None, :, :]  # [1,nq,1,1,qc,kc]
        sblk = torch.where(mask6, sblk, NEG_INF)
        m_new = torch.maximum(m_run, sblk.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(sblk - m_new[..., None])
        p = torch.where(mask6, p, 0.0)
        l_run = l_run * alpha + p.sum(dim=-1)
        upd = torch.einsum("bnhgqk,bkhd->bnhgqd", *_promoted(p.to(q.dtype), vb)).float()
        acc = acc * alpha[..., None] + upd
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-9)[..., None]
    out = out.to(q.dtype).permute(0, 1, 4, 2, 3, 5)  # b,nq,qc,hkv,g,dh
    return out.reshape(b, s, hq, dh)


def attention_forward(
    params: dict,
    x: torch.Tensor,           # [B, S, D]
    cfg: LMConfig,
    *,
    angles: torch.Tensor | None,   # [B, S, Dh//2] rope angles (None: no rope)
    window: int | None = None,
    causal: bool = True,
    impl: str = "xla",
) -> torch.Tensor:
    """Full-sequence (prefill / scoring) self-attention."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    if impl == "flash":
        out = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
            block_q=min(512, s), block_k=min(512, s),
        ).transpose(1, 2)
    elif impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}: 'xla' or 'flash'")
    elif s >= 8192:  # long-context: never materialize S×S scores
        out = _sdpa_flash_xla(q, k, v, cfg, causal=causal, window=window)
    else:
        qpos = torch.arange(s, device=x.device)[:, None]
        kpos = torch.arange(s, device=x.device)[None, :]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        out = _sdpa_xla(q, k, v, mask.expand(b, s, s), cfg)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype)


def attention_decode(
    params: dict,
    x: torch.Tensor,           # [B, 1, D]
    cfg: LMConfig,
    cache: AttnCache,
    cache_pos: int | torch.Tensor,  # a position, or [B] per-slot positions
    *,
    angles: torch.Tensor | None,    # [B, 1, Dh//2]
    window: int | None = None,
) -> tuple[torch.Tensor, AttnCache]:
    """Single-token decode against a (possibly ring-buffered) KV cache,
    written in place."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg)
    if angles is not None:
        q = apply_rope(q, angles)
        k_new = apply_rope(k_new, angles)
    slot_len = cache.k.shape[1]
    cp = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device).expand(b)
    if window is not None:
        slot = cp % slot_len  # ring buffer
    else:
        slot = torch.clamp_max(cp, slot_len - 1)
    rows = torch.arange(b, device=x.device)
    slot = slot.long()
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[rows, slot] = cp
    valid = (cache.pos >= 0) & (cache.pos <= cp[:, None])
    if window is not None:
        valid &= cache.pos > (cp - window)[:, None]
    out = _sdpa_xla(q, cache.k, cache.v, valid[:, None, :], cfg)  # [B,1,Hq,Dh]
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
    out, wo = _promoted(out, params["wo"].to(x.dtype))
    return out @ wo, cache


def cross_attention_forward(
    params: dict,
    x: torch.Tensor,                            # [B, Sq, D]
    kv: tuple[torch.Tensor, torch.Tensor],      # the encoder's K/V [B, Sk, Hkv, Dh]
    cfg: LMConfig,
) -> torch.Tensor:
    """Cross-attention to precomputed encoder K/V: the plain attention over
    an all-true mask, as in the reference (no kernel)."""
    b, sq, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    k, v = kv
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa_xla(q, k, v, mask, cfg).reshape(b, sq, -1)
    out, wo = _promoted(out, params["wo"].to(x.dtype))
    return out @ wo


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg: LMConfig):
    """The cross-attention K/V of the encoder states ``[B, Sk, D]``:
    ``(k, v)``, each ``[B, Sk, Hkv, Dh]``."""
    b, sk, _ = enc_out.shape
    k = (enc_out @ params["wk"].to(enc_out.dtype)).reshape(b, sk, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"].to(enc_out.dtype)).reshape(b, sk, cfg.num_kv_heads, cfg.head_dim)
    return k, v
