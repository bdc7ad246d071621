"""GQA attention: RoPE, qk-norm, bias, windowing, KV cache, and the
encoder-decoder's cross-attention.

The counterpart of ``repro/models/lm/attention.py``.  Two implementations
of the full-sequence path with the same semantics:

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

Under the ``model`` mesh axis (``ms``, a ``dist.ModelSplit``) the layer
holds the ``tp`` posture's pieces: the column blocks of ``wq``/``wk``/``wv``
and their biases (the flattened ``heads``/``kv_heads`` columns, cut as the
reference's ``NamedSharding`` cuts them) and the row block of ``wo``; one
all-reduce follows ``wo``.  The reference's ``shard`` marks name that
layout; the port realises it by one of two routes (:func:`attention_route`):

  * "local heads" where the ranks split the q heads evenly: each rank runs
    attention on its own q heads, with the K/V heads their GQA groups need,
    from its own ``wk``/``wv`` block where the blocks line up (kv heads a
    multiple of the ranks), else from the all-gathered K/V columns;
  * "replicated" otherwise (llama's 24 heads over 16 ranks): the q/k/v
    columns are all-gathered, attention runs whole on every rank, and each
    rank feeds its column block of the output to its ``wo`` rows.

Both compute one card's function; ``impl="flash"`` launches #7 on the
heads a rank attends over.
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


def _attend(q, k, v, cfg: LMConfig, *, causal: bool, window: int | None, impl: str):
    """Full-sequence attention of q [B,S,Hq,Dh] over k/v [B,S,Hkv,Dh]."""
    b, s = q.shape[:2]
    if impl == "flash":
        return flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
            block_q=min(512, s), block_k=min(512, s),
        ).transpose(1, 2)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}: 'xla' or 'flash'")
    if s >= 8192:  # long-context: never materialize S×S scores
        return _sdpa_flash_xla(q, k, v, cfg, causal=causal, window=window)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return _sdpa_xla(q, k, v, mask.expand(b, s, s), cfg)


def attention_route(cfg: LMConfig, model_ranks: int) -> str:
    """The route of a layer whose heads ride ``model_ranks`` ranks: "local
    heads" where they split the q heads evenly, else "replicated" (one
    rank: the one-card path, "local heads" of all of them)."""
    return "local heads" if cfg.num_heads % model_ranks == 0 else "replicated"


def _split_qkv(params, x, cfg: LMConfig, ms):
    """This rank's column blocks of the q, k and v projections of ``x``
    (biases added), ``[B, S, cols]`` each."""
    x = ms.cotangent(x)
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _as_heads(params, t, cfg: LMConfig, norm: str, ms):
    """``t [B, S, cols]`` as heads, qk-normed.  The norm's scale is whole on
    every rank and meets other heads on each, so its gradient sums the
    ranks' parts."""
    b, s, cols = t.shape
    t = t.reshape(b, s, cols // cfg.head_dim, cfg.head_dim)
    return rms_norm(t, ms.cotangent(params[norm]), cfg.norm_eps) if cfg.qk_norm else t


def _local_heads(params, q, k, v, cfg: LMConfig, ms):
    """Route "local heads": this rank's q heads ``[h0, h1)`` and the K/V
    heads their GQA groups read, repeated where the rank's q heads do not
    fall into whole groups of its K/V heads."""
    h0, h1 = ms.block(cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    kv0, kv1 = h0 // group, (h1 - 1) // group + 1
    if cfg.num_kv_heads % ms.size:  # the blocks do not line up: gather the K/V columns
        k = _as_heads(params, ms.gather(k), cfg, "k_norm", ms)[:, :, kv0:kv1]
        v = ms.gather(v).reshape(k.shape[:2] + (cfg.num_kv_heads, cfg.head_dim))[:, :, kv0:kv1]
    else:  # the rank's own K/V block holds exactly those heads
        k, v = _as_heads(params, k, cfg, "k_norm", ms), v.reshape(k.shape[:2] + (-1, cfg.head_dim))
    q = _as_heads(params, q, cfg, "q_norm", ms)
    idx = [(h0 + j) // group - kv0 for j in range(h1 - h0)]
    n = kv1 - kv0
    if (h1 - h0) % n or idx != [j // ((h1 - h0) // n) for j in range(h1 - h0)]:
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def attention_forward(
    params: dict,
    x: torch.Tensor,           # [B, S, D]
    cfg: LMConfig,
    *,
    angles: torch.Tensor | None,   # [B, S, Dh//2] rope angles (None: no rope)
    window: int | None = None,
    causal: bool = True,
    impl: str = "xla",
    ms=None,                   # dist.ModelSplit: params are this rank's pieces
) -> torch.Tensor:
    """Full-sequence (prefill / scoring) self-attention."""
    b, s, _ = x.shape
    if ms is None:
        q, k, v = _project_qkv(params, x, cfg)
    elif attention_route(cfg, ms.size) == "local heads":
        q, k, v = _local_heads(params, *_split_qkv(params, x, cfg, ms), cfg, ms)
    else:
        q, k, v = (ms.gather(t) for t in _split_qkv(params, x, cfg, ms))
        q, k = _as_heads(params, q, cfg, "q_norm", ms), _as_heads(params, k, cfg, "k_norm", ms)
        v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    out = _attend(q, k, v, cfg, causal=causal, window=window, impl=impl)
    out = out.reshape(b, s, -1)
    if ms is None:
        return out @ params["wo"].to(x.dtype)
    if attention_route(cfg, ms.size) == "replicated":  # this rank's column block
        out = out[..., slice(*ms.block(out.shape[-1]))]
    return ms.sum(out @ params["wo"].to(x.dtype))


def _split_decode_attend(q, cache: AttnCache, valid, cfg: LMConfig, ms):
    """:func:`_sdpa_xla` of one query over a cache whose slots the ``model``
    ranks hold in blocks (sequence-sharded): each rank's scores over its
    slots, the max over the ranks, then one all-reduce of each rank's
    unnormalised ``exp(s - max) @ v`` and its sum, in float32; the same
    on every rank."""
    b, sq, hq, dh = q.shape
    hkv = cache.k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", *_promoted(qg, cache.k)).float() * (dh ** -0.5)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    e = torch.exp(logits - ms.max(logits.amax(dim=-1, keepdim=True)))
    acc = torch.einsum("bhgqk,bkhd->bqhgd", *_promoted(e, cache.v)).float()
    sums = ms.sum(torch.cat([acc.reshape(-1), e.sum(dim=-1).reshape(-1)]))
    acc, l_sum = sums[:acc.numel()].view_as(acc), sums[acc.numel():].view(b, hkv, -1, sq)
    return (acc / l_sum.permute(0, 3, 1, 2)[..., None]).to(q.dtype).reshape(b, sq, hq, dh)


def attention_decode(
    params: dict,
    x: torch.Tensor,           # [B, 1, D]
    cfg: LMConfig,
    cache: AttnCache,
    cache_pos: int | torch.Tensor,  # a position, or [B] per-slot positions
    *,
    angles: torch.Tensor | None,    # [B, 1, Dh//2]
    window: int | None = None,
    ms=None,                   # dist.ModelSplit: params are this rank's pieces
    seq_split: bool = False,   # the cache holds this rank's block of slots
) -> tuple[torch.Tensor, AttnCache]:
    """Single-token decode against a (possibly ring-buffered) KV cache,
    written in place.

    Under a model split the cache holds every head, so the q/k/v columns
    are gathered; with ``seq_split`` the ranks hold the slots in blocks
    (the reference's sequence-sharded KV): the rank whose block holds the
    token's slot writes it, and the ranks' partial softmaxes are combined
    by their max and sums (:func:`_split_decode_attend`).  Each rank then
    feeds its column block of the output to its ``wo`` rows."""
    b = x.shape[0]
    if ms is None:
        q, k_new, v_new = _project_qkv(params, x, cfg)
    else:
        q, k_new, v_new = (ms.gather(t) for t in _split_qkv(params, x, cfg, ms))
        q, k_new = _as_heads(params, q, cfg, "q_norm", ms), _as_heads(params, k_new, cfg,
                                                                      "k_norm", ms)
        v_new = v_new.reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
    if angles is not None:
        q = apply_rope(q, angles)
        k_new = apply_rope(k_new, angles)
    slot_len = cache.k.shape[1]
    split = ms is not None and seq_split
    total = slot_len * ms.size if split else slot_len
    cp = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device).expand(b)
    if window is not None:
        slot = cp % total  # ring buffer
    else:
        slot = torch.clamp_max(cp, total - 1)
    rows = torch.arange(b, device=x.device)
    slot = slot.long()
    k_new, v_new = k_new[:, 0].to(cache.k.dtype), v_new[:, 0].to(cache.v.dtype)
    if split:  # the owner writes; the other ranks write back what their slot held
        slot = slot - ms.rank * slot_len
        own = (slot >= 0) & (slot < slot_len)
        slot = slot.clamp(0, slot_len - 1)
        k_new = torch.where(own[:, None, None], k_new, cache.k[rows, slot])
        v_new = torch.where(own[:, None, None], v_new, cache.v[rows, slot])
        cp_new = torch.where(own, cp, cache.pos[rows, slot])
    else:
        cp_new = cp
    cache.k[rows, slot] = k_new
    cache.v[rows, slot] = v_new
    cache.pos[rows, slot] = cp_new
    valid = (cache.pos >= 0) & (cache.pos <= cp[:, None])
    if window is not None:
        valid &= cache.pos > (cp - window)[:, None]
    if split:
        out = _split_decode_attend(q, cache, valid, cfg, ms)
    else:
        out = _sdpa_xla(q, cache.k, cache.v, valid[:, None, :], cfg)  # [B,1,Hq,Dh]
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
    if ms is not None:
        out = out[..., slice(*ms.block(out.shape[-1]))]
    out, wo = _promoted(out, params["wo"].to(x.dtype))
    return (out @ wo if ms is None else ms.sum(out @ wo)), cache


def cross_attention_forward(
    params: dict,
    x: torch.Tensor,                            # [B, Sq, D]
    kv: tuple[torch.Tensor, torch.Tensor],      # the encoder's K/V [B, Sk, Hkv, Dh]
    cfg: LMConfig,
    ms=None,
) -> torch.Tensor:
    """Cross-attention to precomputed encoder K/V: the plain attention over
    an all-true mask, as in the reference (no kernel).  ``ms``: the params
    are this rank's pieces and ``kv`` this rank's K/V columns
    (:func:`encode_cross_kv`), by the self-attention's routes."""
    b, sq, _ = x.shape
    if ms is not None:
        q = ms.cotangent(x) @ params["wq"].to(x.dtype)
        if attention_route(cfg, ms.size) == "local heads":
            q, k, v = _local_heads(params, q, *kv, cfg, ms)
        else:
            q, k, v = (ms.gather(t) for t in (q, *kv))
            q = q.reshape(b, sq, cfg.num_heads, cfg.head_dim)
            k, v = (t.reshape(b, -1, cfg.num_kv_heads, cfg.head_dim) for t in (k, v))
    else:
        q = (x @ params["wq"].to(x.dtype)).reshape(b, sq, cfg.num_heads, cfg.head_dim)
        k, v = kv
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa_xla(q, k, v, mask, cfg).reshape(b, sq, -1)
    if ms is not None and attention_route(cfg, ms.size) == "replicated":
        out = out[..., slice(*ms.block(out.shape[-1]))]
    out, wo = _promoted(out, params["wo"].to(x.dtype))
    return out @ wo if ms is None else ms.sum(out @ wo)


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg: LMConfig, ms=None):
    """The cross-attention K/V of the encoder states ``[B, Sk, D]``:
    ``(k, v)``, each ``[B, Sk, Hkv, Dh]``; ``ms``: this rank's column
    blocks ``[B, Sk, Hkv·Dh / m]``, for :func:`cross_attention_forward`."""
    b, sk, _ = enc_out.shape
    if ms is not None:
        enc_out = ms.cotangent(enc_out)
        return tuple(enc_out @ params[w].to(enc_out.dtype) for w in ("wk", "wv"))
    k = (enc_out @ params["wk"].to(enc_out.dtype)).reshape(b, sk, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"].to(enc_out.dtype)).reshape(b, sk, cfg.num_kv_heads, cfg.head_dim)
    return k, v
