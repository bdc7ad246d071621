"""Fault-tolerant training loop: checkpoint/restart with exact replay (the
counterpart of ``repro.train.loop``, run eagerly with no ``jit``).

The loop owns nothing it cannot reconstruct: model state comes from the
latest checkpoint (atomic manifest dirs), data from a counter-based
pipeline whose state rides in the checkpoint aux, so a crash at any step
resumes bit-identically.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from ..checkpoint import (
    latest_step,
    reshard_to,
    restore_checkpoint,
    save_checkpoint,
    writes_checkpoints,
)
from ..data.pipeline import SyntheticHGNNData
from ..obs.emit import Emitter
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.trace import trace_span
from .step import TrainState


def _restore_latest(ckpt_dir: str, state: TrainState,
                    mesh) -> tuple[int | None, TrainState, dict]:
    """(step, state, aux) of the latest checkpoint, or (None, state, {}).

    With a lane mesh, lane rank 0 alone reads the disk and decides; the
    other ranks take its step and aux through a broadcast and its leaves
    through ``reshard_to``.  So every rank starts from rank 0's step, also
    where the others see another directory or none (no shared file
    system), and no rank skips the collectives the others enter."""
    found = [None, {}]
    if writes_checkpoints(mesh):
        last = latest_step(ckpt_dir)
        if last is not None:
            state, aux = restore_checkpoint(ckpt_dir, last, state)
            found = [last, aux]
    if mesh is not None:
        group = mesh.get_group("lane")
        dev = state.step.device
        dist.broadcast_object_list(found, src=dist.get_global_rank(group, 0), group=group,
                                   device=dev if dev.type == "cuda" else None)
    last, aux = found
    if last is not None:
        state = reshard_to(state, mesh=mesh)
    return last, state, aux


def train_loop(
    *,
    state: TrainState,
    train_step: Callable,
    data: SyntheticHGNNData,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = True,
    crash_at: int | None = None,  # fault-injection hook for tests
    log_every: int = 10,
    log: Callable[[str], None] = print,
    registry: MetricsRegistry | None = None,
    mesh=None,  # lane mesh: restored state replicated over it, lane rank 0 writes
) -> tuple[TrainState, list[dict]]:
    """Run train steps ``[start, steps)`` with checkpointing and structured
    logging; ``start`` is the latest checkpoint's step when resuming.

    With a lane ``mesh`` (``launch.mesh.make_lane_mesh``) every rank runs
    the loop in step: lane rank 0 alone reads and writes checkpoints, and
    a restored state is placed by ``reshard_to`` over the lane group
    (elastic restart: any lane count restores any checkpoint).

    Observability (DESIGN.md §12), into ``registry`` (default: the
    process-wide one, ``obs.get_registry()``): every step increments
    ``train.steps`` and lands its wall time in the ``train.step_ms``
    histogram; logged steps set the ``train.loss``/``train.grad_norm``
    gauges and emit a ``[train] step=… loss=… sec=…`` record through
    :class:`Emitter`.  On the card each step ends with a device
    synchronise, so ``sec`` and ``train.step_ms`` are the step's latency,
    not its enqueue time.
    """
    reg = registry if registry is not None else get_registry()
    em = Emitter(sink=log)
    step_ms = reg.histogram("train.step_ms")
    steps_c = reg.counter("train.steps")
    dev = state.step.device
    writer = bool(ckpt_dir) and writes_checkpoints(mesh)

    start = 0
    if ckpt_dir and resume:
        last, state, aux = _restore_latest(ckpt_dir, state, mesh)
        if last is not None:
            data.restore(aux["data"])
            start = last
            em.emit("resume", step=last)

    history: list[dict] = []
    try:
        for step in range(start, steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = data.next()
            with trace_span("train/step", step=step) as sp:
                state, metrics = train_step(state, batch)
                sp.sync(metrics["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if step % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["sec"] = dt
                history.append(m)
                reg.gauge("train.loss").set(m["loss"])
                reg.gauge("train.grad_norm").set(m["grad_norm"])
                em.emit("train", step=step, loss=m["loss"], gnorm=m["grad_norm"], sec=dt)
            step_ms.observe(dt * 1e3)
            steps_c.inc()
            if writer and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1, state, aux={"data": data.state()})
        if writer:
            save_checkpoint(ckpt_dir, steps, state, aux={"data": data.state()})
    finally:
        em.close()
    return state, history
