"""Unified model API, the counterpart of ``repro/models/lm/api.py``: one
object per architecture that ``launch/`` and ``serve/`` drive without
knowing the family internals."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ...runtime import resolve_device
from . import encdec, transformer
from .config import LMConfig


@dataclasses.dataclass(frozen=True)
class LMApi:
    cfg: LMConfig
    # init(generator, device="cuda") -> params
    init: Callable[..., Any]
    # axes() -> the params' logical axes (one tuple of axis names a leaf)
    axes: Callable[[], Any]
    # forward(params, tokens, **kw) -> (logits, aux)
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    # decode(params, tokens, cache_pos, caches, **kw) -> (logits, caches);
    # the encoder-decoder takes cross_kv= (``encdec.precompute_cross``); both
    # take mesh=, placements=, cache_placements= (their ``decode_step``)
    decode: Callable[..., tuple[torch.Tensor, Any]]
    # init_caches(batch, cache_len, dtype=torch.bfloat16, device="cuda") -> caches
    init_caches: Callable[..., Any]

    @property
    def name(self) -> str:
        return self.cfg.name


def build(cfg: LMConfig) -> LMApi:
    """The API of ``cfg``'s model: the encoder-decoder (``encdec``) or the
    decoder stack (``transformer``).  ``init`` draws random weights from a
    generator (on its device) and places them on ``device``, and
    ``init_caches`` builds on ``device``: the card unless the caller asks
    for the CPU."""
    if cfg.is_encoder_decoder:
        family, init_fn, caches_fn = encdec, encdec.init_encdec, encdec.init_encdec_caches
        axes_fn = encdec.encdec_axes

        def dec(params, tokens, cache_pos, caches, *, cross_kv, **kw):
            return encdec.decode_step(params, cfg, tokens, cache_pos, caches, cross_kv, **kw)
    else:
        transformer.check_supported(cfg)
        family, init_fn, caches_fn = transformer, transformer.init_decoder, transformer.init_caches
        axes_fn = transformer.decoder_axes

        def dec(params, tokens, cache_pos, caches, **kw):
            return transformer.decode_step(params, cfg, tokens, cache_pos, caches, **kw)

    def init(generator: torch.Generator, device: str | torch.device = "cuda"):
        return init_fn(cfg, generator, resolve_device(device))

    def fwd(params, tokens, **kw):
        return family.forward(params, cfg, tokens, **kw)

    def init_caches(batch, cache_len, dtype=torch.bfloat16, device="cuda"):
        return caches_fn(cfg, batch, cache_len, dtype, resolve_device(device))

    return LMApi(cfg=cfg, init=init, axes=lambda: axes_fn(cfg), forward=fwd, decode=dec,
                 init_caches=init_caches)
