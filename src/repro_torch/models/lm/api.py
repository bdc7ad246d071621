"""Unified model API, the counterpart of ``repro/models/lm/api.py``: one
object per architecture that ``launch/`` and ``serve/`` drive without
knowing the family internals."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ...runtime import resolve_device
from . import transformer
from .config import LMConfig


@dataclasses.dataclass(frozen=True)
class LMApi:
    cfg: LMConfig
    # init(generator, device="cuda") -> params
    init: Callable[..., Any]
    # forward(params, tokens, **kw) -> (logits, aux)
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    # decode(params, tokens, cache_pos, caches) -> (logits, caches)
    decode: Callable[..., tuple[torch.Tensor, Any]]
    # init_caches(batch, cache_len, dtype=torch.bfloat16, device="cuda") -> caches
    init_caches: Callable[..., Any]

    @property
    def name(self) -> str:
        return self.cfg.name


def build(cfg: LMConfig) -> LMApi:
    """The API of ``cfg``'s decoder.  Raises ``NotImplementedError`` (naming
    its ROADMAP item) for a family this slice does not port."""
    transformer.check_supported(cfg)

    def init(generator: torch.Generator, device: str | torch.device = "cuda"):
        """Random weights from ``generator`` (drawn on its device), placed on
        ``device``: the card unless the caller asks for the CPU."""
        return transformer.init_decoder(cfg, generator, resolve_device(device))

    def fwd(params, tokens, **kw):
        return transformer.forward(params, cfg, tokens, **kw)

    def dec(params, tokens, cache_pos, caches):
        return transformer.decode_step(params, cfg, tokens, cache_pos, caches)

    def init_caches(batch, cache_len, dtype=torch.bfloat16, device="cuda"):
        return transformer.init_caches(cfg, batch, cache_len, dtype, resolve_device(device))

    return LMApi(cfg=cfg, init=init, forward=fwd, decode=dec, init_caches=init_caches)
