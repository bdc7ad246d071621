"""The decoder stack, the counterpart of ``repro/models/lm/transformer.py``.

Parameters keep the reference's tree: layers are grouped into
*superblocks* (one period of ``cfg.block_pattern``) whose weights stack
on a leading ``[n_super]`` axis under ``params["scan"]["pos{i}"]``, and
remainder layers sit in the ``params["tail"]`` list.  A Python loop over
the stacked axis takes the place of ``jax.lax.scan``.

  * forward()      — full sequence (prefill / scoring), returns logits
  * decode_step()  — one token against carried caches (serving)

The stack runs "attn" and "local" blocks with a dense MLP or MoE
(``moe.py``), "ssm" blocks (mamba2, ``ssm.py``) and "rglru" blocks with a
GeGLU MLP (``rglru.py``), under RoPE or Qwen2-VL's M-RoPE (positions
``[B, S, 3]``), with visual embeddings in the first slots.  A block's
decode cache is an ``AttnCache`` (a full context, or a ring of
``cfg.window`` slots for "local") or a recurrent ``(conv, state)`` tuple,
O(1) in context.  The encoder-decoder is ``encdec.py``.

``cfg.remat`` is the reference's memory policy for the backward, and
changes no value: "full" recomputes each superblock (the body of the
reference's scan) in the backward and keeps only its input, "dots" keeps
the products with no batch dims (``aten.mm``: the weight products) and
recomputes the rest, as ``checkpoint_dots_with_no_batch_dims`` does.  The
tail layers run outside it, as in the reference.

Under a mesh (``forward(..., mesh=, placements=)``, the placements
``dist.param_shardings`` gives :func:`decoder_axes` under the rules) the
params are this rank's pieces.  Each block first gathers its leaves' data
pieces (``fsdp``: ``embed`` over the data axes; ``dist.gather_fsdp``,
inside the remat region, so the backward gathers them again), and its
modules then compute on their ``model`` pieces (``dist.ModelSplit``): the
attention, MLP and MoE as their modules say, the embedding by ``vocab``
rows (a lookup masked to the rank's range, then one all-reduce) and the
head by ``vocab`` columns (logits split by vocab; gathered unless the
caller takes them split, as the loss does).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ...dist.sharding import gather_fsdp, map_placements, model_split
from ...tree import tree_leaves, tree_map
from .attention import AttnCache, attention_decode, attention_forward, attention_specs, init_attn_cache
from .config import LMConfig
from .layers import (
    P,
    axes_from_specs,
    init_from_specs,
    mrope_angles,
    rms_norm,
    rope_angles,
    torch_dtype,
)
from .mlp import mlp_forward, mlp_specs
from .moe import moe_forward, moe_specs
from .rglru import init_rglru_cache, rglru_decode, rglru_forward, rglru_specs
from .ssm import init_ssm_cache, ssm_decode, ssm_forward, ssm_specs

ATTENTION = ("attn", "local")
RECURRENT = ("ssm", "rglru")


def check_supported(cfg: LMConfig) -> None:
    """Raise ``ValueError`` for a block pattern the stack does not know."""
    for pat in cfg.block_pattern:
        if pat not in ATTENTION + RECURRENT:
            raise ValueError(pat)


def vocab_padded(cfg: LMConfig) -> int:
    return ((cfg.vocab_size + 255) // 256) * 256


def _block_specs(cfg: LMConfig, pat: str, layers: int | None) -> dict:
    d = cfg.d_model
    lead = () if layers is None else (layers,)
    lx = () if layers is None else ("layers",)
    norm = lambda: P(lead + (d,), lx + (None,), init="ones")  # noqa: E731
    if pat == "ssm":
        return {"norm1": norm(), "ssm": ssm_specs(cfg, layers=layers)}
    if pat == "rglru":
        return {"norm1": norm(), "rglru": rglru_specs(cfg, layers=layers), "norm2": norm(),
                "mlp": mlp_specs(cfg, layers=layers)}
    mixer = {"norm1": norm(), "attn": attention_specs(cfg, layers=layers), "norm2": norm()}
    if cfg.is_moe:
        return mixer | {"moe": moe_specs(cfg, layers=layers)}
    return mixer | {"mlp": mlp_specs(cfg, layers=layers)}


def _layout(cfg: LMConfig) -> tuple[int, int]:
    period = len(cfg.block_pattern)
    return cfg.num_layers // period, cfg.num_layers % period


def decoder_specs(cfg: LMConfig) -> dict:
    check_supported(cfg)
    n_super, rem = _layout(cfg)
    vp = vocab_padded(cfg)
    specs: dict[str, Any] = {
        "embed": P((vp, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "final_norm": P((cfg.d_model,), (None,), init="ones"),
    }
    if n_super > 0:
        specs["scan"] = {
            f"pos{i}": _block_specs(cfg, pat, n_super)
            for i, pat in enumerate(cfg.block_pattern)
        }
    if rem:
        specs["tail"] = [
            _block_specs(cfg, cfg.block_pattern[i], None) for i in range(rem)
        ]
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((cfg.d_model, vp), ("embed", "vocab"), scale=0.02)
    return specs


def init_decoder(cfg: LMConfig, generator: torch.Generator, device=None):
    return init_from_specs(decoder_specs(cfg), generator, torch_dtype(cfg.param_dtype), device)


def decoder_axes(cfg: LMConfig):
    """The logical axes of :func:`decoder_specs`' params."""
    return axes_from_specs(decoder_specs(cfg))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (``[n_super, ...]``) tree, as views."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

def _save_dots_without_batch_dims(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: a product with no batch dims
    is ``aten.mm`` (``x @ W`` reaches it flattened); ``bmm`` (attention,
    the experts) has one."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn, cfg: LMConfig):
    """``fn`` under ``cfg.remat``'s policy where autograd records it (grad
    mode on, a tensor of its arguments requiring grad), else ``fn`` itself.
    Anything ``fn`` appends to a list (MoE ``routes``) is appended again
    when the backward recomputes it."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots_without_batch_dims)

    def wrapped(*args):
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _angles(cfg: LMConfig, positions: torch.Tensor) -> torch.Tensor:
    if cfg.m_rope:
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.m_rope_sections)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _ffn(cfg: LMConfig, p: dict, x: torch.Tensor, routes: list | None = None, ms=None):
    """The block's MLP or MoE: (out, the MoE's aux loss or None)."""
    if cfg.is_moe:
        return moe_forward(p["moe"], x, cfg, routes=routes, ms=ms)
    return mlp_forward(p["mlp"], x, cfg, ms), None


def _block_forward(cfg: LMConfig, pat: str, p: dict, h: torch.Tensor, angles, impl: str,
                   routes: list | None, ms=None):
    """One block, full-sequence.  Returns (h, aux_loss or None).  ``ms``:
    ``p`` holds this rank's ``model`` pieces (attention and FFN blocks)."""
    if pat == "ssm":
        y, _ = ssm_forward(p["ssm"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg, ms=ms)
        return h + y, None
    if pat == "rglru":
        y, _ = rglru_forward(p["rglru"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg, ms=ms)
        h = h + y
        return h + mlp_forward(p["mlp"], rms_norm(h, p["norm2"], cfg.norm_eps), cfg, ms), None
    win = cfg.window if pat == "local" else None
    a = attention_forward(
        p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
        angles=angles, window=win, impl=impl, ms=ms,
    )
    h = h + a
    m, aux = _ffn(cfg, p, rms_norm(h, p["norm2"], cfg.norm_eps), routes, ms)
    return h + m, aux


def _block_decode(cfg: LMConfig, pat: str, p: dict, h, angles, cache, cache_pos, ms=None,
                  seq_split: bool = False):
    """One block, single token.  Returns (h, cache): the attention cache
    written in place, or the recurrent block's new ``(conv, state)``.
    ``ms``: ``p`` holds this rank's ``model`` pieces; ``seq_split``: the
    cache holds this rank's block of slots (``attention_decode``)."""
    if pat == "ssm":
        y, cache = ssm_decode(p["ssm"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg, *cache,
                              ms=ms)
        return h + y, cache
    if pat == "rglru":
        y, cache = rglru_decode(p["rglru"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg, *cache,
                                ms=ms)
        h = h + y
        return h + mlp_forward(p["mlp"], rms_norm(h, p["norm2"], cfg.norm_eps), cfg, ms), cache
    win = cfg.window if pat == "local" else None
    a, cache = attention_decode(
        p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
        cache, cache_pos, angles=angles, window=win, ms=ms, seq_split=seq_split,
    )
    h = h + a
    return h + _ffn(cfg, p, rms_norm(h, p["norm2"], cfg.norm_eps), None, ms)[0], cache


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / scoring)
# ---------------------------------------------------------------------------

def lookup(table: torch.Tensor, tokens: torch.Tensor, ms=None) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``; ``ms``: ``table`` is this rank's
    block of ``vocab`` rows, looked up where a token falls in it (zero rows
    elsewhere) and summed over the ranks (exact: one term is not zero)."""
    if ms is None:
        return table[tokens.long()]
    t = tokens.long() - ms.rank * table.shape[0]
    inside = (t >= 0) & (t < table.shape[0])
    return ms.sum(torch.where(inside[..., None], table[t.clamp(0, table.shape[0] - 1)], 0))


def embed_tokens(params, cfg: LMConfig, tokens: torch.Tensor, ms=None) -> torch.Tensor:
    """The embedding of ``tokens`` (:func:`lookup`)."""
    h = lookup(params["embed"], tokens, ms).to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return h


def logits_from_hidden(params, cfg: LMConfig, h: torch.Tensor, ms=None) -> torch.Tensor:
    """The logits of the final hidden state; ``ms``: this rank's block of
    ``vocab`` columns (the head's, or the tied embedding's rows)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if ms is not None:
        h = ms.cotangent(h)
    if cfg.tie_embeddings:
        return h @ params["embed"].t().to(h.dtype)
    return h @ params["lm_head"].to(h.dtype)


def _per_layer(placements):
    """The placements of one layer's slice of stacked (``[n_super, ...]``)
    leaves: each ``Shard`` one dim lower (the layer dim is never split)."""
    return map_placements(
        lambda pl: tuple(Shard(q.dim - 1) if isinstance(q, Shard) else q for q in pl),
        placements)


def _whole_over_data(mesh, placements):
    """``gather(p, pl)``: a params subtree's leaves with their data pieces
    gathered (``dist.gather_fsdp``), left with their ``model`` split; the
    subtree itself with no mesh or placements."""
    def gather(p, pl):
        if mesh is None or pl is None:
            return p
        return map_placements(lambda a, x: gather_fsdp(x, a, mesh), pl, p)

    return gather


def forward(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,                  # [B, S] int
    *,
    positions: torch.Tensor | None = None,  # [B, S], or [B, S, 3] (m_rope)
    visual_embeds: torch.Tensor | None = None,  # [B, n_vis, D] stub frontend output
    impl: str = "xla",
    routes: list | None = None,
    mesh=None,
    placements=None,
    split_logits: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S, vocab_padded], aux_loss): the float32 sum of
    every MoE layer's balance term, in layer order (zero for the dense
    family).  ``routes``, when given, receives each MoE layer's
    ``moe.Routing`` in layer order.  ``visual_embeds`` (precomputed patch
    embeddings) take the first ``n_vis`` slots, cast to the hidden dtype.

    ``mesh`` and ``placements`` (the module docstring): the params are this
    rank's pieces, and every rank of the mesh calls the forward.  The
    logits are then whole on every rank, or with ``split_logits`` this
    rank's block of ``vocab_padded`` over ``model``."""
    check_supported(cfg)
    ms = model_split(mesh)
    if ms is not None and placements is None:
        raise ValueError("a model split needs the params' placements")
    whole = _whole_over_data(mesh, placements)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        if cfg.m_rope:  # text only: t == h == w
            positions = positions[..., None].expand(b, s, 3)
    angles = _angles(cfg, positions)

    keys = [k for k in ("embed", "final_norm", "lm_head") if k in params]
    top = whole({k: params[k] for k in keys},
                None if placements is None else {k: placements[k] for k in keys})
    h = embed_tokens(top, cfg, tokens, ms)
    if visual_embeds is not None:
        nv = visual_embeds.shape[1]
        h = torch.cat([visual_embeds.to(h.dtype), h[:, nv:]], dim=1)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def block(pat, p, h, aux_total):
        h, aux = _block_forward(cfg, pat, p, h, angles, impl, routes, ms)
        return h, aux_total if aux is None else aux_total + aux

    scan_pl = None if placements is None or "scan" not in placements else \
        _per_layer(placements["scan"])

    def superblock(h, aux_total, sp):
        sp = whole(sp, scan_pl)
        for i, pat in enumerate(cfg.block_pattern):
            h, aux_total = block(pat, sp[f"pos{i}"], h, aux_total)
        return h, aux_total

    superblock = maybe_remat(superblock, cfg)
    n_super, rem = _layout(cfg)
    for layer in range(n_super):
        h, aux_total = superblock(h, aux_total, _layer(params["scan"], layer))
    for i in range(rem):
        p = whole(params["tail"][i], None if placements is None else placements["tail"][i])
        h, aux_total = block(cfg.block_pattern[i], p, h, aux_total)
    logits = logits_from_hidden(top, cfg, h, ms)
    if ms is not None and not split_logits:
        logits = ms.gather_replicated(logits)
    return logits, aux_total


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _cache_map(fn, cache):
    """``fn`` over the tensors of one block's cache: an ``AttnCache`` or a
    recurrent ``(conv, state)`` tuple."""
    if isinstance(cache, AttnCache):
        return AttnCache(*(fn(t) for t in (cache.k, cache.v, cache.pos)))
    return tuple(fn(t) for t in cache)


def _cache_for(cfg: LMConfig, pat: str, batch: int, cache_len: int, dtype, device,
               lead: tuple[int, ...] = ()):
    """An empty cache of one block: the full context for "attn", a ring
    buffer of ``cfg.window`` slots for "local", ``(conv, state)`` for
    "ssm" and "rglru" (the state float32); ``lead`` stacks it."""
    if pat == "ssm":
        c = init_ssm_cache(cfg, batch, dtype, device)
    elif pat == "rglru":
        c = init_rglru_cache(cfg, batch, dtype, device)
    else:
        eff_cfg = cfg if pat == "local" else dataclasses.replace(cfg, window=None)
        c = init_attn_cache(eff_cfg, batch, cache_len, dtype, device)
    return _cache_map(lambda t: t.expand(lead + t.shape).clone(), c) if lead else c


def init_caches(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                device="cuda"):
    """Stacked caches matching the parameter layout: ``scan`` (a leading
    ``[n_super]`` axis on every tensor) and the ``tail`` list."""
    check_supported(cfg)
    n_super, rem = _layout(cfg)
    caches: dict[str, Any] = {}
    if n_super > 0:
        caches["scan"] = {
            f"pos{i}": _cache_for(cfg, pat, batch, cache_len, dtype, device, (n_super,))
            for i, pat in enumerate(cfg.block_pattern)
        }
    if rem:
        caches["tail"] = [
            _cache_for(cfg, cfg.block_pattern[i], batch, cache_len, dtype, device)
            for i in range(rem)
        ]
    return caches


def _block_caches(caches):
    """(container, key, cache) of every block cache in a cache tree."""
    for k, c in caches.get("scan", {}).items():
        yield caches["scan"], k, c
    for i, c in enumerate(caches.get("tail", [])):
        yield caches["tail"], i, c


def _attn_caches(caches):
    if isinstance(caches, AttnCache):  # the encoder-decoder's stacked self-attention caches
        yield caches
        return
    for _, _, c in _block_caches(caches):
        if isinstance(c, AttnCache):
            yield c


def mark_cache_filled(caches, cache_pos: int):
    """Mark attention cache slots [0, cache_pos) as holding real history
    (in place; returns ``caches``).  Recurrent states are left as they are."""
    for c in _attn_caches(caches):
        n = c.pos.shape[-1]
        pos = torch.arange(n, dtype=torch.int32, device=c.pos.device).expand(c.pos.shape)
        c.pos.copy_(torch.where(pos < cache_pos, pos, -1))
    return caches


def decode_dtype(cfg: LMConfig, cache_dtype: torch.dtype) -> torch.dtype:
    """The dtype of decode's hidden state with caches of ``cache_dtype``.
    Attention against the caches computes in the promoted type of the two;
    the recurrent blocks cast their output back to ``cfg.dtype`` whatever
    their states' type.  So a config with an attention block decodes in
    the promoted type, and one without in ``cfg.dtype``."""
    compute = torch_dtype(cfg.dtype)
    if any(pat in ATTENTION for pat in cfg.block_pattern):
        return torch.promote_types(compute, cache_dtype)
    return compute


def check_cache_dtype(cfg: LMConfig, dtype: torch.dtype) -> None:
    """Raise unless decode keeps the hidden state in ``cfg.dtype`` with
    caches of ``dtype`` (:func:`decode_dtype`).  Where an attention block
    turns it wider (bfloat16 compute, float32 caches) the reference's scan
    over layers refuses the wider carry with a TypeError, so the port
    refuses it too rather than produce a result the reference cannot.
    mamba2 (no attention) decodes at bfloat16 against float32 states in
    both packages."""
    wider = decode_dtype(cfg, dtype)
    if wider != torch_dtype(cfg.dtype):
        raise ValueError(
            f"{cfg.name}: decode with {dtype} caches at compute dtype {cfg.dtype} is outside "
            f"the reference's domain (attention against the caches turns its scan carry "
            f"{wider}); see ROADMAP Queue 3")


def _widen_conv_states(cfg: LMConfig, caches) -> None:
    """The reference's recurrent blocks return their conv state in the
    promoted type of the cache's and the compute dtype, so a float32-compute
    step turns a bfloat16 conv cache float32.  Such a cache is widened once,
    in place in the tree, so that each step stores its state unrounded."""
    compute = torch_dtype(cfg.dtype)
    for tree, key, c in list(_block_caches(caches)):
        if not isinstance(c, AttnCache):
            conv, state = c
            tree[key] = (conv.to(torch.promote_types(conv.dtype, compute)), state)


def _store(cache, new) -> None:
    """Write a recurrent block's new ``(conv, state)`` into its cache's
    tensors (``attention_decode`` writes an ``AttnCache`` itself)."""
    if not isinstance(cache, AttnCache):
        for t, n in zip(cache, new):
            t.copy_(n)


def _seq_split(placement, mesh) -> bool:
    """Whether a block cache's placements split an attention cache's slots
    over ``model``; a recurrent block's states must stay whole on every
    model rank."""
    if placement is None:
        return False
    d = mesh.mesh_dim_names.index("model")
    if isinstance(placement, AttnCache):
        return isinstance(placement.k[d], Shard)
    if any(isinstance(pl[d], Shard) for pl in placement):
        raise ValueError("a recurrent block's states are whole on every model rank; their "
                         f"placements split them over 'model': {placement}")
    return False


def decode_step(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,            # [B, 1]
    cache_pos: int | torch.Tensor,   # a position, or [B] per-slot positions
    caches,
    *,
    mesh=None,
    placements=None,
    cache_placements=None,
) -> tuple[torch.Tensor, Any]:
    """One decode step: returns (logits [B, 1, vocab_padded], caches),
    the caches updated in place.  ``mesh``/``placements``: the params are
    this rank's pieces (as :func:`forward`'s), ``tokens`` and ``caches``
    this rank's rows, and ``cache_placements`` (``launch.dryrun.
    cache_placements``) say which caches split their slots over ``model``;
    the logits are whole on every rank."""
    check_supported(cfg)
    ms = model_split(mesh)
    if ms is not None and placements is None:
        raise ValueError("a model split needs the params' placements")
    whole = _whole_over_data(mesh, placements)
    for c in _attn_caches(caches):
        check_cache_dtype(cfg, c.k.dtype)
    _widen_conv_states(cfg, caches)
    b = tokens.shape[0]
    # on the device once: each layer then reads it without a host copy
    cache_pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=tokens.device).expand(b)
    positions = cache_pos[:, None]
    if cfg.m_rope:  # a generated token is text: t == h == w
        positions = positions[..., None].expand(b, 1, 3)
    angles = _angles(cfg, positions)

    keys = [k for k in ("embed", "final_norm", "lm_head") if k in params]
    top = whole({k: params[k] for k in keys},
                None if placements is None else {k: placements[k] for k in keys})
    h = embed_tokens(top, cfg, tokens, ms)
    cpl = cache_placements or {}
    split = (lambda pl: False) if ms is None else (lambda pl: _seq_split(pl, mesh))  # noqa: E731
    n_super, rem = _layout(cfg)
    scan_pl = None if placements is None or "scan" not in placements else \
        _per_layer(placements["scan"])
    for layer in range(n_super):
        sp = whole(_layer(params["scan"], layer), scan_pl)
        for i, pat in enumerate(cfg.block_pattern):
            c = _cache_map(lambda t: t[layer], caches["scan"][f"pos{i}"])
            h, new = _block_decode(cfg, pat, sp[f"pos{i}"], h, angles, c, cache_pos, ms,
                                   split(cpl.get("scan", {}).get(f"pos{i}")))
            _store(c, new)
    for i in range(rem):
        c = caches["tail"][i]
        p = whole(params["tail"][i], None if placements is None else placements["tail"][i])
        h, new = _block_decode(cfg, cfg.block_pattern[i], p, h, angles, c, cache_pos, ms,
                               split(cpl["tail"][i] if "tail" in cpl else None))
        _store(c, new)
    logits = logits_from_hidden(top, cfg, h, ms)
    if ms is not None:
        logits = ms.gather_replicated(logits)
    return logits, caches
