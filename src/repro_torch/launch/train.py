"""LM training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --global-batch 16

The counterpart of ``repro/launch/train.py``: the same flags, defaults,
optimizer choice and printed lines (``--smoke``: the reduced config, lr
1e-2, no weight decay, a constant schedule; otherwise the full config,
lr 3e-4, weight decay 0.1, the warmup-cosine schedule), random weights
from a ``torch.Generator`` seeded 0 and ``SyntheticLMData`` seeded 0,
through ``make_train_step`` and the fault-tolerant ``train_loop``
(``--ckpt`` checkpoints and resumes).  ``--device`` defaults to ``cuda``
and raises on a host without a card.

The mesh follows the reference's branch on the number of ranks (one
process a rank; under ``torchrun`` the launcher joins the group it sets
up, NCCL on ``cuda`` and gloo on ``--device cpu``):

* one rank: the one-process path, no mesh;
* more than one: an ``(n, 1)`` data mesh (``mesh.make_data_mesh``) under
  ``make_rules(batch_shard=True, fsdp=False)``: every parameter
  replicated, each microbatch's rows split over ``data``, the grads
  summed over it after the microbatches; one rank logs and writes
  checkpoints, every rank restores, and a checkpoint resumes at any
  number of ranks (``train_loop`` with the mesh and the placements);
* 256 or more without ``--smoke``: the reference's production mesh
  (``mesh.make_production_mesh``: 16 × 16 over ``("data", "model")``, or
  2 × 16 × 16 with ``--multi-pod``) under the ``tp`` rules,
  ``make_rules(fsdp=cfg.fsdp)``: heads, FFN dims, experts and vocab over
  ``model``, every weight's ``embed`` dim over ``data`` where the config
  sets ``fsdp``; each rank holds its pieces of the state and the step
  computes on them (``train.step``).
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..checkpoint import reshard_to, writes_checkpoints
from ..configs import ARCH_IDS, get_config, smoke_config
from ..data import SyntheticLMData
from ..dist import make_rules, param_shardings
from ..models.lm.api import build
from ..optim import AdamWConfig
from ..runtime import resolve_device
from ..train import make_train_step, train_loop
from ..train.step import TrainState, init_train_state, train_state_axes
from .mesh import make_data_mesh, make_production_mesh

SMOKE_LR = 1e-2
PRODUCTION_RANKS = 256  # from here on the reference builds the production mesh


def production(ranks: int, smoke: bool) -> bool:
    """Whether the reference's launcher takes the production mesh."""
    return ranks >= PRODUCTION_RANKS and not smoke


def training_mesh(ranks: int, *, smoke: bool = False, multi_pod: bool = False,
                  device_type: str = "cuda"):
    """The reference launcher's mesh for ``ranks`` ranks: None at one, the
    ``(ranks, 1)`` data mesh below ``PRODUCTION_RANKS`` (or with
    ``smoke``), the production mesh (16 × 16, or 2 × 16 × 16 with
    ``multi_pod``) at or above it."""
    if production(ranks, smoke):
        return make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    return make_data_mesh(ranks, device_type=device_type)


def training_rules(ranks: int, cfg, *, smoke: bool = False, multi_pod: bool = False):
    """The rules of :func:`training_mesh`'s mesh: the ``tp`` rules with the
    config's ``fsdp`` on the production mesh, else the data mesh's (every
    parameter replicated)."""
    if production(ranks, smoke):
        return make_rules(multi_pod=multi_pod, fsdp=cfg.fsdp)
    return make_rules(batch_shard=ranks > 1, fsdp=False)


def run_training(arch: str = "llama3.2-3b", *, smoke: bool = False, steps: int = 20,
                 global_batch: int = 8, seq: int = 32, microbatches: int = 2,
                 ckpt: str | None = None, device: str = "cuda", ckpt_every: int = 50,
                 crash_at: int | None = None, multi_pod: bool = False,
                 log=print) -> tuple[TrainState, list[dict]]:
    """The launcher's run: (final state, logged history).  ``ckpt_every``
    and ``crash_at`` (a failure injected at that step) are
    ``train_loop``'s.  Under an initialised process group of n ranks every
    rank calls it: the mesh and rules of :func:`training_mesh` and
    :func:`training_rules`, each rank holding its pieces of the state, and
    only the writer logs."""
    dev = resolve_device(device)
    ranks = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    mesh = training_mesh(ranks, smoke=smoke, multi_pod=multi_pod, device_type=dev.type)
    if mesh is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not writes_checkpoints(mesh):
        log = lambda *_: None  # noqa: E731
    cfg = smoke_config(arch) if smoke else get_config(arch)
    api = build(cfg)
    opt = AdamWConfig(lr=SMOKE_LR if smoke else 3e-4, weight_decay=0.0 if smoke else 0.1)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=global_batch,
        seed=0, with_frames=cfg.frontend == "audio",
        frame_len=cfg.encoder_seq, d_model=cfg.d_model,
    )
    # one seed on every rank: the replicas start equal, and each cuts its pieces
    state = init_train_state(api, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    placements = None
    if mesh is not None:
        rules = training_rules(ranks, cfg, smoke=smoke, multi_pod=multi_pod)
        placements = param_shardings(mesh, rules, train_state_axes(api, opt, state.params))
        state = reshard_to(state, mesh=mesh, placements=placements)
    step = make_train_step(
        api, opt, microbatches=microbatches,
        lr_schedule=(lambda s: torch.tensor(SMOKE_LR)) if smoke else None, mesh=mesh,
        placements=placements,
    )
    return train_loop(state=state, train_step=step, data=data, steps=steps, ckpt_dir=ckpt,
                      ckpt_every=ckpt_every, log_every=5, crash_at=crash_at, log=log,
                      mesh=mesh, placements=placements)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # under torchrun (one process per rank) the launcher joins the group it sets up
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if joined:
        dist.init_process_group("nccl" if args.device.startswith("cuda") else "gloo")
    try:
        _, hist = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                               global_batch=args.global_batch, seq=args.seq,
                               microbatches=args.microbatches, ckpt=args.ckpt,
                               device=args.device, multi_pod=args.multi_pod)
        if hist and (not dist.is_initialized() or dist.get_rank() == 0):
            print(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
