"""Deterministic, checkpointable data pipelines of the trainers (the
counterparts of ``repro.data.pipeline``: ``SyntheticLMData``,
``SyntheticHGNNData`` and ``hgnn_minibatches``).

Batch t is a pure function of ``(seed, step)``: a restart that restores
``state()`` replays the exact token or vertex stream, which is what makes
checkpoint/restart bitwise reproducible.  The reference draws batches
with threefry; torch cannot reproduce those bits, so batches here come
from a ``torch.Generator`` seeded from ``(seed, step)`` and parity tests
inject the reference's batches instead.  ``batch_size >=
num_vertices`` is full-batch training: ``arange`` every step, as in the
reference.  ``hgnn_minibatches`` is a numpy stream, the reference's bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator keyed on ``(seed, step)``.  Its Mersenne Twister takes
    32 bits of the seed, so the pair is hashed into them
    (``numpy.random.SeedSequence``): a plain ``(seed << 32) + step`` would
    drop the seed."""
    key = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(key))


@dataclasses.dataclass
class SyntheticLMData:
    """Synthetic next-token data with planted structure, so that training
    loss decreases (not pure noise): every token is emitted twice, a
    learnable copy task.  A batch holds CPU int32 ``tokens [B, seq_len +
    1]`` and, ``with_frames``, bf16 ``frames [B, frame_len, d_model]``
    (the audio stub frontend's output, N(0, 0.2²))."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    with_frames: bool = False      # audio stub frontend
    frame_len: int = 0
    d_model: int = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"pipeline seed mismatch: {state['seed']} != {self.seed}")
        self.step = int(state["step"])

    def next(self) -> dict:
        gen = _generator(self.seed, self.step)
        self.step += 1
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        base = torch.randint(0, v, (b, (s + 1) // 2), generator=gen)
        toks = torch.stack([base, base], dim=-1).reshape(b, -1)[:, :s]
        batch = {"tokens": toks.to(torch.int32)}
        if self.with_frames:
            frames = torch.randn((b, self.frame_len, self.d_model), generator=gen) * 0.2
            batch["frames"] = frames.to(torch.bfloat16)
        return batch


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
        gen = _generator(self.seed, step)
        return {"idx": torch.randperm(self.num_vertices, generator=gen)[: self.batch_size]}


def hgnn_minibatches(num_vertices: int, batch_size: int, seed: int = 0):
    """Deterministic vertex-minibatch id stream for HGNN training (int32
    numpy arrays, one permutation an epoch, the last partial batch dropped)."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(num_vertices)
        for i in range(0, num_vertices - batch_size + 1, batch_size):
            yield perm[i : i + batch_size].astype(np.int32)
