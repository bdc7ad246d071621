"""LM training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke --steps 20 --device cpu

The counterpart of ``repro/launch/train.py``: the same flags, defaults,
optimizer choice and printed lines (``--smoke``: the reduced config, lr
1e-2, no weight decay, a constant schedule; otherwise the full config,
lr 3e-4, weight decay 0.1, the warmup-cosine schedule), random weights
from a ``torch.Generator`` seeded 0 and ``SyntheticLMData`` seeded 0,
through ``make_train_step`` and the fault-tolerant ``train_loop``
(``--ckpt`` checkpoints and resumes).  One process on one device:
``--device`` defaults to ``cuda`` and raises on a host without a card.
The reference's data mesh over several devices is ROADMAP item 7j.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..data import SyntheticLMData
from ..models.lm.api import build
from ..optim import AdamWConfig
from ..runtime import resolve_device
from ..train import make_train_step, train_loop
from ..train.step import TrainState, init_train_state

SMOKE_LR = 1e-2


def run_training(arch: str = "llama3.2-3b", *, smoke: bool = False, steps: int = 20,
                 global_batch: int = 8, seq: int = 32, microbatches: int = 2,
                 ckpt: str | None = None, device: str = "cuda", ckpt_every: int = 50,
                 crash_at: int | None = None, log=print) -> tuple[TrainState, list[dict]]:
    """The launcher's run: (final state, logged history).  ``ckpt_every``
    and ``crash_at`` (a failure injected at that step) are
    ``train_loop``'s."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    api = build(cfg)
    opt = AdamWConfig(lr=SMOKE_LR if smoke else 3e-4, weight_decay=0.0 if smoke else 0.1)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=global_batch,
        seed=0, with_frames=cfg.frontend == "audio",
        frame_len=cfg.encoder_seq, d_model=cfg.d_model,
    )
    state = init_train_state(api, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    step = make_train_step(
        api, opt, microbatches=microbatches,
        lr_schedule=(lambda s: torch.tensor(SMOKE_LR)) if smoke else None,
    )
    return train_loop(state=state, train_step=step, data=data, steps=steps, ckpt_dir=ckpt,
                      ckpt_every=ckpt_every, log_every=5, crash_at=crash_at, log=log)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, hist = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                           global_batch=args.global_batch, seq=args.seq,
                           microbatches=args.microbatches, ckpt=args.ckpt, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
