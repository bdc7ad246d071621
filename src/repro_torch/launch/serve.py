"""LM serving launcher of the port: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu

The counterpart of ``repro/launch/serve.py``: the same flags and printed
lines, prompts from ``np.random.default_rng(0)``, random weights from a
``torch.Generator`` seeded 0.  ``--device`` defaults to ``cuda`` and
raises on a host without a card.  Like the reference, the greedy server
runs only configs whose decode keeps the compute dtype against its
float32 caches (the float32 ``--smoke`` ones, and mamba2 at bfloat16): a
full config with attention blocks computes in bfloat16 and raises
``ValueError`` before any work (see
``serve/engine.py:check_greedy_domain``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..models.lm.api import build
from ..runtime import resolve_device
from ..serve.engine import check_greedy_domain, greedy_generate


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg)
    check_greedy_domain(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)), dtype=torch.int32,
        device=dev,
    )
    t0 = time.time()
    out = greedy_generate(
        api, params, prompts, steps=args.steps,
        cache_len=args.prompt_len + args.steps + 1,
    )
    out = out.cpu().numpy()
    dt = time.time() - t0
    print(f"{cfg.name}: {args.batch * args.steps} tokens in {dt:.2f}s")
    print(out)


if __name__ == "__main__":
    main()
