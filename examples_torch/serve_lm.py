"""Serve a small LM with batched requests: prefill + batched greedy decode,
on the PyTorch port.

    PYTHONPATH=src python examples_torch/serve_lm.py --arch llama3.2-3b --steps 16
    PYTHONPATH=src python examples_torch/serve_lm.py --arch whisper-large-v3 --device cpu

The twin of ``examples/serve_lm.py``: the reduced (smoke) config of any
architecture, random weights from a ``torch.Generator`` seeded 0, prompts
from ``np.random.default_rng(0)``, and the same printed lines.
``--device`` defaults to ``cuda`` and raises on a host without a card.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models.lm.api import build
from repro_torch.runtime import resolve_device
from repro_torch.serve.engine import greedy_generate


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (args.batch, 8)),
                              dtype=torch.int32, device=dev)

    t0 = time.time()
    out = greedy_generate(api, params, prompts, steps=args.steps, cache_len=8 + args.steps + 1)
    out = out.cpu().numpy()
    dt = time.time() - t0
    toks = args.batch * args.steps
    print(f"arch={cfg.name} family={cfg.family}")
    print(f"generated {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s on {dev.type})")
    for i, row in enumerate(out):
        print(f"  request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
