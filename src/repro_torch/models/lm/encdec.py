"""Whisper-style encoder-decoder backbone, the counterpart of
``repro/models/lm/encdec.py`` (audio frontend stubbed).

The conv/mel frontend is a stub: the caller supplies frame embeddings
``[B, S_enc, d_model]``.  Architecture: a pre-LN MHA encoder
(bidirectional) and a decoder with causal self-attention, cross-attention
to the encoder output, GELU MLPs, learned decoder positions and a tied LM
head (whisper-large-v3: 32 encoder + 32 decoder layers, d 1280, 20
heads).  Layers stack on a leading ``[L]`` axis, as the reference's scan
carries them; a Python loop over it takes the place of ``jax.lax.scan``.

The encoder's and the decoder's self-attention run through ``impl``
("flash" is kernel #7: ``causal=False`` in the encoder); cross-attention is
the plain attention over an all-true mask, as in the reference.
``cfg.remat`` applies to each encoder and decoder layer's body
(``transformer.maybe_remat``), as the reference's ``_maybe_remat`` wraps
its scan bodies; it changes no value.

Decode writes the self-attention caches in place; the cross K/V are
computed once per prompt batch (:func:`precompute_cross`).
"""
from __future__ import annotations

import functools

import torch

from ...dist.sharding import model_split
from .attention import (
    AttnCache,
    attention_decode,
    attention_forward,
    attention_specs,
    cross_attention_forward,
    encode_cross_kv,
    init_attn_cache,
)
from .config import LMConfig
from .layers import (
    P,
    axes_from_specs,
    init_from_specs,
    layer_norm,
    sinusoidal_positions,
    torch_dtype,
)
from .mlp import mlp_forward, mlp_specs
from .transformer import (
    _layer,
    _per_layer,
    _seq_split,
    _whole_over_data,
    check_cache_dtype,
    lookup,
    maybe_remat,
    vocab_padded,
)

STACKED = ("encoder", "decoder")  # the params' subtrees stacked on a layer axis
DEC_POSITIONS = 32768  # the reference's learned decoder table (whisper's own context is 448)


def _norm_specs(layers: int | None, d: int) -> dict:
    lead = () if layers is None else (layers,)
    lx = () if layers is None else ("layers",)
    return {
        "scale": P(lead + (d,), lx + (None,), init="ones"),
        "bias": P(lead + (d,), lx + (None,), init="zeros"),
    }


def encdec_specs(cfg: LMConfig) -> dict:
    d = cfg.d_model
    le, ld = cfg.encoder_layers, cfg.num_layers
    enc_block = {
        "norm1": _norm_specs(le, d),
        "attn": attention_specs(cfg, layers=le),
        "norm2": _norm_specs(le, d),
        "mlp": mlp_specs(cfg, layers=le),
    }
    dec_block = {
        "norm1": _norm_specs(ld, d),
        "self_attn": attention_specs(cfg, layers=ld),
        "norm_x": _norm_specs(ld, d),
        "cross_attn": attention_specs(cfg, layers=ld, cross=True),
        "norm2": _norm_specs(ld, d),
        "mlp": mlp_specs(cfg, layers=ld),
    }
    return {
        "embed": P((vocab_padded(cfg), d), ("vocab", "embed"), scale=0.02),
        "dec_pos": P((DEC_POSITIONS, d), (None, "embed"), scale=0.01),
        "encoder": enc_block,
        "enc_final": _norm_specs(None, d),
        "decoder": dec_block,
        "dec_final": _norm_specs(None, d),
    }


def init_encdec(cfg: LMConfig, generator: torch.Generator, device=None):
    return init_from_specs(encdec_specs(cfg), generator, torch_dtype(cfg.param_dtype), device)


def encdec_axes(cfg: LMConfig):
    """The logical axes of :func:`encdec_specs`' params."""
    return axes_from_specs(encdec_specs(cfg))


def _ln(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return layer_norm(x, p["scale"].float(), p["bias"].float(), eps)


def _logits(params, h: torch.Tensor, ms=None) -> torch.Tensor:
    """The tied head's logits; ``ms``: this rank's block of ``vocab``."""
    h = _ln(params["dec_final"], h)
    if ms is not None:
        h = ms.cotangent(h)
    return h @ params["embed"].t().to(h.dtype)


def encode(params, cfg: LMConfig, frames: torch.Tensor, *, impl: str = "xla",
           ms=None, whole=None) -> torch.Tensor:
    """frames ``[B, S_enc, D]`` (the stub frontend's output) -> encoder
    states, bidirectional self-attention through ``impl``; ``ms``: the
    params are this rank's pieces, and ``whole(p)`` gathers a layer's
    data pieces (:func:`forward`)."""
    _, s, d = frames.shape
    h = frames + sinusoidal_positions(s, d).to(frames.device)[None].to(frames.dtype)

    def block(h, p):
        p = p if whole is None else whole(p)
        h = h + attention_forward(p["attn"], _ln(p["norm1"], h), cfg, angles=None,
                                  causal=False, impl=impl, ms=ms)
        return h + mlp_forward(p["mlp"], _ln(p["norm2"], h), cfg, ms)

    block = maybe_remat(block, cfg)
    for i in range(cfg.encoder_layers):
        h = block(h, _layer(params["encoder"], i))
    return _ln(params["enc_final"], h)


def _embed(params, cfg: LMConfig, tokens: torch.Tensor, ms=None) -> torch.Tensor:
    return lookup(params["embed"], tokens, ms).to(torch_dtype(cfg.dtype))


def decode_train(params, cfg: LMConfig, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 impl: str = "xla", ms=None, whole=None) -> torch.Tensor:
    """The teacher-forced decoder pass -> logits ``[B, S, vocab_padded]``:
    causal self-attention through ``impl``, then cross-attention to
    ``enc_out``; ``ms`` and ``whole``: :func:`encode`'s, the logits this
    rank's block of ``vocab``."""
    s = tokens.shape[1]
    h = _embed(params, cfg, tokens, ms)
    h = h + params["dec_pos"][:s][None].to(h.dtype)

    def block(h, enc_out, p):
        p = p if whole is None else whole(p)
        h = h + attention_forward(p["self_attn"], _ln(p["norm1"], h), cfg, angles=None,
                                  causal=True, impl=impl, ms=ms)
        kv = encode_cross_kv(p["cross_attn"], enc_out, cfg, ms)
        h = h + cross_attention_forward(p["cross_attn"], _ln(p["norm_x"], h), kv, cfg, ms)
        return h + mlp_forward(p["mlp"], _ln(p["norm2"], h), cfg, ms)

    block = maybe_remat(block, cfg)
    for i in range(cfg.num_layers):
        h = block(h, enc_out, _layer(params["decoder"], i))
    return _logits(params, h, ms)


def forward(params, cfg: LMConfig, tokens: torch.Tensor, *, frames: torch.Tensor | None = None,
            impl: str = "xla", mesh=None, placements=None,
            split_logits: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole pass: (logits, aux), aux zero.  ``frames`` default to
    zeros of ``[B, cfg.encoder_seq, D]`` (the stub).  ``mesh``/``placements``:
    the params are this rank's pieces, gathered over the data axes first
    (``fsdp``), the encoder and the decoder computing on their ``model``
    pieces as ``transformer.forward``'s blocks do (cross-attention by the
    self-attention's routes); the logits whole on every rank, or with
    ``split_logits`` this rank's block of ``vocab``."""
    ms, params, enc, dec = _on_mesh(params, mesh, placements)
    if frames is None:
        frames = torch.zeros((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device=tokens.device)
    enc_out = encode(params, cfg, frames, impl=impl, ms=ms, whole=enc)
    logits = decode_train(params, cfg, tokens, enc_out, impl=impl, ms=ms, whole=dec)
    if ms is not None and not split_logits:
        logits = ms.gather_replicated(logits)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def _on_mesh(params, mesh, placements):
    """(ms, params, enc, dec) under ``mesh``: the ``ModelSplit``, the params
    with their top-level leaves' data pieces gathered, and the encoder's and
    decoder's per-layer gathers (``whole`` of :func:`encode` and
    :func:`decode_train`, None with no placements)."""
    ms = model_split(mesh)
    if ms is not None and placements is None:
        raise ValueError("a model split needs the params' placements")
    if mesh is None or placements is None:
        return ms, params, None, None
    gather = _whole_over_data(mesh, placements)  # the data pieces, a layer at a time
    top = [k for k in params if k not in STACKED]
    params = dict(params, **gather({k: params[k] for k in top},
                                   {k: placements[k] for k in top}))
    enc, dec = (functools.partial(gather, pl=_per_layer(placements[k])) for k in STACKED)
    return ms, params, enc, dec


def init_encdec_caches(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                       device="cuda") -> AttnCache:
    """The decoder's self-attention caches, stacked ``[L, ...]``; the cross
    K/V come from :func:`precompute_cross`."""
    c = init_attn_cache(cfg, batch, cache_len, dtype, device)
    return AttnCache(*(t.expand((cfg.num_layers,) + t.shape).clone() for t in (c.k, c.v, c.pos)))


def precompute_cross(params, cfg: LMConfig, enc_out: torch.Tensor, *, ms=None, whole=None):
    """Every decoder layer's cross K/V of ``enc_out``, stacked:
    ``(k, v)``, each ``[L, B, S_enc, Hkv, Dh]``; ``ms`` and ``whole``:
    :func:`decode_train`'s, each layer's K/V columns gathered, so that every
    model rank holds the whole cross K/V (the reference's heuristic
    replicates them over ``model``: no dim is a cache length)."""
    b, sk, _ = enc_out.shape
    shape = (b, sk, cfg.num_kv_heads, cfg.head_dim)
    kv = []
    for i in range(cfg.num_layers):
        p = _layer(params["decoder"], i)
        p = p if whole is None else whole(p)
        k, v = encode_cross_kv(p["cross_attn"], enc_out, cfg, ms)
        kv.append((k, v) if ms is None else tuple(ms.gather(t).reshape(shape) for t in (k, v)))
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def encode_for_decode(params, cfg: LMConfig, frames: torch.Tensor, *, mesh=None,
                      placements=None):
    """The prompt batch's cross K/V for decoding (:func:`encode`, then
    :func:`precompute_cross`); ``mesh``/``placements``: :func:`forward`'s,
    the K/V whole on every model rank."""
    ms, params, enc, dec = _on_mesh(params, mesh, placements)
    enc_out = encode(params, cfg, frames, ms=ms, whole=enc)
    return precompute_cross(params, cfg, enc_out, ms=ms, whole=dec)


def decode_step(params, cfg: LMConfig, tokens: torch.Tensor, cache_pos: int | torch.Tensor,
                caches: AttnCache, cross_kv, *, mesh=None, placements=None,
                cache_placements=None) -> tuple[torch.Tensor, AttnCache]:
    """One decoder token: (logits ``[B, 1, vocab_padded]``, caches), the
    caches written in place.  ``cache_pos`` is a position, or a ``[B]``
    tensor of per-slot positions (continuous batching).  ``mesh``,
    ``placements`` and ``cache_placements``: ``transformer.decode_step``'s,
    ``cross_kv`` whole on every model rank (:func:`precompute_cross`); a
    rank attends over its own heads' columns of it."""
    check_cache_dtype(cfg, caches.k.dtype)
    check_cache_dtype(cfg, cross_kv[0].dtype)
    ms, params, _, dec = _on_mesh(params, mesh, placements)
    split = ms is not None and _seq_split(cache_placements, mesh)
    b = tokens.shape[0]
    cache_pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=tokens.device).expand(b)
    h = _embed(params, cfg, tokens, ms)
    h = h + params["dec_pos"][cache_pos.long()][:, None].to(h.dtype)
    for i in range(cfg.num_layers):
        p = _layer(params["decoder"], i)
        p = p if dec is None else dec(p)
        cache = AttnCache(caches.k[i], caches.v[i], caches.pos[i])
        a, _ = attention_decode(p["self_attn"], _ln(p["norm1"], h), cfg, cache, cache_pos,
                                angles=None, ms=ms, seq_split=split)
        h = h + a
        kv = (cross_kv[0][i], cross_kv[1][i])
        if ms is not None:  # this rank's columns of the whole K/V
            cols = slice(*ms.block(cfg.num_kv_heads * cfg.head_dim))
            kv = tuple(t.reshape(t.shape[:2] + (-1,))[..., cols] for t in kv)
        h = h + cross_attention_forward(p["cross_attn"], _ln(p["norm_x"], h), kv, cfg, ms)
        h = h + mlp_forward(p["mlp"], _ln(p["norm2"], h), cfg, ms)
    logits = _logits(params, h, ms)
    return (logits if ms is None else ms.gather_replicated(logits)), caches
