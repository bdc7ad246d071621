"""LM serving engine, the counterpart of ``repro/serve/engine.py``:
prefill as a loop of decode steps, then decode against carried caches.

``ServeState.cache_pos`` is a Python int (the host always knows the
position, so no step reads the device for it); caches are updated in
place by each step.  An encoder-decoder's state also carries the cross
K/V (``cross_kv``): zero placeholders until ``prefill`` encodes the
prompt batch's frames.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.lm import encdec
from ..models.lm.api import LMApi
from ..models.lm.layers import torch_dtype
from ..models.lm.transformer import decode_dtype, mark_cache_filled

GREEDY_CACHE_DTYPE = torch.float32  # the reference's greedy_generate builds float32 caches


@dataclasses.dataclass
class ServeState:
    caches: Any
    cache_pos: int
    cross_kv: Any = None  # the encoder-decoder's stacked (k, v)


def init_serve_state(
    api: LMApi, batch: int, cache_len: int, *, dtype=torch.bfloat16, filled: int = 0,
    device: str | torch.device = "cuda",
) -> ServeState:
    caches = api.init_caches(batch, cache_len, dtype, device)
    if filled:
        caches = mark_cache_filled(caches, filled)
    cross = None
    if api.cfg.is_encoder_decoder:  # the reference's placeholders until prefill encodes frames
        cfg = api.cfg
        shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        cross = tuple(torch.zeros(shape, dtype=dtype, device=caches.k.device) for _ in range(2))
    return ServeState(caches=caches, cache_pos=filled, cross_kv=cross)


def make_serve_step(api: LMApi, *, mesh=None, placements=None,
                    cache_placements=None) -> Callable:
    """(params, state, tokens [B,1]) -> (logits [B, vocab_pad], state).
    ``mesh``, ``placements`` and ``cache_placements``: decode under a mesh,
    the params, tokens and caches this rank's pieces
    (``transformer.decode_step``; the caches laid out by
    ``launch.dryrun.cache_placements``, the reference's heuristic)."""
    has_cross = api.cfg.is_encoder_decoder
    on_mesh = {} if mesh is None else dict(mesh=mesh, placements=placements,
                                           cache_placements=cache_placements)

    def serve_step(params, state: ServeState, tokens: torch.Tensor):
        kw = dict(on_mesh, cross_kv=state.cross_kv) if has_cross else dict(on_mesh)
        logits, caches = api.decode(params, tokens, state.cache_pos, state.caches, **kw)
        return logits[:, 0], ServeState(caches=caches, cache_pos=state.cache_pos + 1,
                                        cross_kv=state.cross_kv)

    return serve_step


def make_prefill(api: LMApi, **on_mesh) -> Callable:
    """(params, state, tokens [B,S], frames=None) -> (last logits, state) —
    fills the caches by running decode steps, one token at a time.  An
    encoder-decoder first encodes ``frames`` ``[B, S_enc, D]`` and
    precomputes every layer's cross K/V from them.  ``on_mesh``:
    :func:`make_serve_step`'s."""
    serve_step = make_serve_step(api, **on_mesh)
    cfg = api.cfg
    mesh_kw = {k: on_mesh[k] for k in ("mesh", "placements") if k in on_mesh}

    def prefill(params, state: ServeState, tokens: torch.Tensor, frames=None):
        if cfg.is_encoder_decoder:
            state = dataclasses.replace(state, cross_kv=encdec.encode_for_decode(
                params, cfg, frames, **mesh_kw))
        logits = None
        for t in range(tokens.shape[1]):
            logits, state = serve_step(params, state, tokens[:, t:t + 1])
        return logits, state

    return prefill


def check_greedy_domain(cfg) -> None:
    """Raise ``ValueError`` for a config the reference's ``greedy_generate``
    cannot run.  It builds float32 caches (``repro/serve/engine.py:100``);
    at a bfloat16 compute dtype attention against them promotes the hidden
    state to float32, which the reference's scan over layers refuses (a
    TypeError on its carry).  So it runs only configs whose decode keeps
    the compute dtype (``transformer.decode_dtype``): every float32-compute
    config, and mamba2 (no attention block) at bfloat16 too.  ROADMAP
    Queue 3 records this property of the reference.  ``make_prefill`` and
    ``make_serve_step`` with bfloat16 caches serve the rest in both
    packages."""
    wider = decode_dtype(cfg, GREEDY_CACHE_DTYPE)
    if wider != torch_dtype(cfg.dtype):
        raise ValueError(
            f"{cfg.name}: the reference's greedy_generate cannot run compute dtype {cfg.dtype}: "
            f"it builds float32 caches (repro/serve/engine.py:100), attention against them "
            f"returns a {wider} hidden state, and its scan over layers refuses it (see "
            f"ROADMAP Queue 3).  Serve it through make_prefill / make_serve_step with "
            f"bfloat16 caches, or use a float32 compute dtype.")


def greedy_generate(api: LMApi, params, prompt: torch.Tensor, steps: int, cache_len: int):
    """Simple batched greedy decoding; tokens [B, steps] int32."""
    check_greedy_domain(api.cfg)
    b = prompt.shape[0]
    state = init_serve_state(api, b, cache_len, dtype=GREEDY_CACHE_DTYPE, device=prompt.device)
    prefill = make_prefill(api)
    serve_step = make_serve_step(api)
    kw = {}
    if api.cfg.is_encoder_decoder:
        kw["frames"] = torch.zeros((b, api.cfg.encoder_seq, api.cfg.d_model),
                                   dtype=torch.float32, device=prompt.device)
    logits, state = prefill(params, state, prompt, **kw)
    out = []
    tok = torch.argmax(logits[:, : api.cfg.vocab_size], dim=-1).to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, state = serve_step(params, state, tok[:, None])
        tok = torch.argmax(logits[:, : api.cfg.vocab_size], dim=-1).to(torch.int32)
    return torch.stack(out, dim=1)
