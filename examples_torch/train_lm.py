"""End-to-end LM training driver on the PyTorch port (reduced config) with
the full production loop: microbatched AdamW, checkpoint/resume, fault
injection.

    PYTHONPATH=src python examples_torch/train_lm.py --arch qwen2-7b --steps 100
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 20

The twin of ``examples/train_lm.py``: the smoke config of any
architecture, random weights from a ``torch.Generator`` seeded 0,
``SyntheticLMData`` seeded 0 (global batch 8 of 32 tokens), and the same
printed line.  ``--device`` defaults to ``cuda`` and raises on a host
without a card.
"""
import argparse

import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.models.lm.api import build
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import resolve_device
from repro_torch.train import make_train_step, train_loop
from repro_torch.train.step import init_train_state


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    api = build(cfg)
    opt = AdamWConfig(lr=1e-2, weight_decay=0.0)
    state = init_train_state(api, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    step = make_train_step(
        api, opt, microbatches=args.microbatches, lr_schedule=lambda s: torch.tensor(1e-2)
    )
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0,
        with_frames=cfg.frontend == "audio", frame_len=cfg.encoder_seq, d_model=cfg.d_model,
    )
    state, hist = train_loop(
        state=state, train_step=step, data=data, steps=args.steps,
        ckpt_dir=args.ckpt, log_every=10,
    )
    print(f"final loss: {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
