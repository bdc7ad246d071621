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

from ..checkpoint import (
    broadcast_from_writer,
    latest_step,
    logical_state,
    read_leaves,
    reshard_to,
    save_checkpoint,
    writes_checkpoints,
)
from ..data.pipeline import SyntheticHGNNData, SyntheticLMData
from ..obs.emit import Emitter
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.trace import trace_span, tracing_enabled
from ..tree import tree_leaves
from .step import TrainState


def _restore_latest(ckpt_dir: str, state: TrainState, mesh,
                    placements) -> tuple[int | None, TrainState, dict]:
    """(step, state, aux) of the latest checkpoint, or (None, state, {}).

    With a mesh, the writer (``writes_checkpoints``) alone reads the disk
    and decides; every rank takes its step, aux and logical leaves through
    broadcasts over the mesh, then ``reshard_to`` cuts its own slices.  So
    every rank starts from the writer's step, also where the others see
    another directory or none (no shared file system), and no rank skips
    the collectives the others enter.  Every rank restores into its
    state's logical form (``logical_state``) in place: the writer reads
    the files into it, the others receive the broadcast into it (where
    nothing shards a leaf, that is the state's own tensor)."""
    writer = writes_checkpoints(mesh)
    found = [latest_step(ckpt_dir) if writer else None]
    dev = state.step.device
    if mesh is not None:
        broadcast_from_writer(mesh, dev, objects=found)
    if found[0] is None:
        return None, state, {}
    logical = logical_state(state, mesh, placements)
    aux = [None]
    if writer:  # in place: a resumed run holds one state, not two
        aux[0], pairs = read_leaves(ckpt_dir, found[0], logical)
        for v, t in pairs:
            if t.shape != v.shape or t.dtype != v.dtype:
                raise ValueError(f"checkpoint step {found[0]} in {ckpt_dir} holds a "
                                 f"{t.dtype} {tuple(t.shape)} leaf where the state has "
                                 f"{v.dtype} {tuple(v.shape)}")
            v.copy_(t)
    if mesh is not None:
        broadcast_from_writer(mesh, dev, objects=aux, tensors=tree_leaves(logical))
    return found[0], reshard_to(logical, mesh=mesh, placements=placements), aux[0]


def _device_mallocs(dev: torch.device) -> int:
    """cudaMalloc calls the caching allocator has made on ``dev``."""
    return torch.cuda.memory_stats(dev)["num_device_alloc"]


def train_loop(
    *,
    state: TrainState,
    train_step: Callable,
    data: SyntheticLMData | SyntheticHGNNData,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = True,
    crash_at: int | None = None,  # fault-injection hook for tests
    log_every: int = 10,
    log: Callable[[str], None] = print,
    log_jsonl: str | None = None,  # mirror structured records to a JSONL file
    registry: MetricsRegistry | None = None,
    mesh=None,  # (lane, model) or data mesh: one rank reads and writes, every rank restores
    placements=None,  # dist.param_shardings of the state: its leaves are pieces
) -> tuple[TrainState, list[dict]]:
    """Run train steps ``[start, steps)`` with checkpointing and structured
    logging; ``start`` is the latest checkpoint's step when resuming.

    With a ``mesh`` (``launch.mesh.make_lane_mesh`` or ``make_data_mesh``)
    every rank runs the loop in step.  The state's leaves are this rank's pieces by
    ``placements`` (all whole when None).  One rank (``writes_checkpoints``)
    reads and writes checkpoints; a checkpoint holds the logical leaves,
    gathered over the mesh on every rank before the writer writes them,
    and a restored state is broadcast from the writer and cut to each
    rank's slices by ``reshard_to`` (elastic restart: any mesh restores
    any checkpoint).

    Observability (DESIGN.md §12), into ``registry`` (default: the
    process-wide one, ``obs.get_registry()``): every step increments
    ``train.steps`` and lands its wall time in the ``train.step_ms``
    histogram; logged steps set the ``train.loss``/``train.grad_norm``
    gauges and emit a ``[train] step=… loss=… sec=…`` record through
    :class:`Emitter` (mirrored to ``log_jsonl`` when given).  On the card
    each step ends with a device synchronise, so ``sec`` and
    ``train.step_ms`` are the step's latency, not its enqueue time.  Each
    step is a ``train/step`` span; on the card, under a tracer enabled when
    the loop starts, the span's ``device_mallocs`` counts the caching
    allocator's cudaMalloc calls from the step's start to that synchronise.

    The LM step (``make_train_step``) updates the state in place and the
    HGNN step returns a new one; the loop takes the state each returns.
    """
    reg = registry if registry is not None else get_registry()
    em = Emitter(sink=log, jsonl_path=log_jsonl)
    step_ms = reg.histogram("train.step_ms")
    steps_c = reg.counter("train.steps")
    dev = state.step.device
    writer = writes_checkpoints(mesh)

    saved = [None]  # the step of the checkpoint last written or restored

    def checkpoint(step: int) -> None:  # every rank gathers, the writer writes
        logical = logical_state(state, mesh, placements)
        if writer:
            save_checkpoint(ckpt_dir, step, logical, aux={"data": data.state()})
        saved[0] = step

    start = 0
    if ckpt_dir and resume:
        last, state, aux = _restore_latest(ckpt_dir, state, mesh, placements)
        if last is not None:
            data.restore(aux["data"])
            start = saved[0] = last
            em.emit("resume", step=last)

    history: list[dict] = []
    count_mallocs = dev.type == "cuda" and tracing_enabled()
    try:
        for step in range(start, steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = data.next()
            with trace_span("train/step", step=step) as sp:
                mallocs = _device_mallocs(dev) if count_mallocs else 0
                state, metrics = train_step(state, batch)
                sp.sync(metrics["loss"])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    if count_mallocs:
                        sp.annotate(device_mallocs=_device_mallocs(dev) - mallocs)
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
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                checkpoint(step + 1)
        if ckpt_dir and saved[0] != steps:
            checkpoint(steps)  # unless this step's checkpoint was just written or read
    finally:
        em.close()
    return state, history
