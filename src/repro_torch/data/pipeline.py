"""Deterministic, checkpointable data pipelines of the HGNN trainer (the
counterparts of ``repro.data.pipeline.SyntheticHGNNData`` and
``hgnn_minibatches``).

Batch t is a pure function of ``(seed, step)``: a restart that restores
``state()`` replays the exact vertex stream, which is what makes
checkpoint/restart bitwise reproducible.  The reference draws minibatches
with threefry; torch cannot reproduce those bits, so minibatches here come
from a ``torch.Generator`` seeded from ``(seed, step)`` and parity tests
inject the reference's ``idx`` stream instead.  ``batch_size >=
num_vertices`` is full-batch training: ``arange`` every step, as in the
reference.  ``hgnn_minibatches`` is a numpy stream, the reference's bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticHGNNData:
    """Counter-based labeled-vertex minibatch stream (CPU int64 ``idx``)."""

    num_vertices: int
    batch_size: int
    seed: int = 0
    step: int = 0

    def __post_init__(self):
        if self.num_vertices <= 0 or self.batch_size <= 0:
            raise ValueError("num_vertices and batch_size must be positive")

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"pipeline seed mismatch: {state['seed']} != {self.seed}")
        self.step = int(state["step"])

    def next(self) -> dict:
        step = self.step
        self.step += 1
        if self.batch_size >= self.num_vertices:
            return {"idx": torch.arange(self.num_vertices)}
        gen = torch.Generator().manual_seed((self.seed << 32) + step)
        return {"idx": torch.randperm(self.num_vertices, generator=gen)[: self.batch_size]}


def hgnn_minibatches(num_vertices: int, batch_size: int, seed: int = 0):
    """Deterministic vertex-minibatch id stream for HGNN training (int32
    numpy arrays, one permutation an epoch, the last partial batch dropped)."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(num_vertices)
        for i in range(0, num_vertices - batch_size + 1, batch_size):
            yield perm[i : i + batch_size].astype(np.int32)
