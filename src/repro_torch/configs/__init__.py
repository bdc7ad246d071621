"""Architecture & shape registry for the assigned pool.

``get_config(arch_id)`` returns the full published config;
``smoke_config(arch_id)`` a drastically reduced same-family variant for
CPU smoke tests.  SHAPES carries the four assigned input shapes; cell
applicability (decode/long-context) is computed here so the dry-run,
tests and EXPERIMENTS.md all agree on the 40-cell grid.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.lm.config import LMConfig

ARCH_IDS = [
    "qwen2-vl-7b",
    "llama3.2-3b",
    "qwen2-7b",
    "qwen3-8b",
    "minitron-4b",
    "mamba2-2.7b",
    "whisper-large-v3",
    "recurrentgemma-9b",
    "dbrx-132b",
    "grok-1-314b",
]

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-8b": "qwen3_8b",
    "minitron-4b": "minitron_4b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
}


def get_config(arch_id: str) -> LMConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def smoke_config(arch_id: str) -> LMConfig:
    """Reduced same-family config: small layers/width/experts/vocab."""
    cfg = get_config(arch_id)
    period = len(cfg.block_pattern)
    overrides = dict(
        num_layers=max(2, period + min(1, cfg.num_layers % period)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=257,
        dtype="float32",
        param_dtype="float32",
        fsdp=False,
        remat="none",
    )
    if cfg.is_moe:
        overrides.update(num_experts=4, experts_per_tok=2)
    if cfg.family == "ssm":
        overrides.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8, num_heads=1, num_kv_heads=1)
    if cfg.rnn_width:
        overrides.update(rnn_width=64)
    if cfg.window:
        overrides.update(window=8)
    if cfg.is_encoder_decoder:
        overrides.update(encoder_layers=2, encoder_seq=16)
    if cfg.m_rope:
        overrides.update(head_dim=16, m_rope_sections=(2, 3, 3))
    return dataclasses.replace(cfg, **overrides)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: LMConfig, shape: Shape) -> tuple[bool, str]:
    """Is (arch × shape) runnable?  Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k dense KV decode is quadratic-in-context (DESIGN.md §5)"
    return True, ""


def grid():
    """All 40 (arch, shape) cells with support flags."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_supported(cfg, s)
            out.append((a, s.name, ok, why))
    return out
