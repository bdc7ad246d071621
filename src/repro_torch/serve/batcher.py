"""Continuous batching: slot-based request scheduling over a fixed batch,
the counterpart of ``repro/serve/batcher.py``.

Serving keeps the decode batch full by admitting new requests into slots
as old ones finish; the decode step keeps one shape.  Each slot carries
its own cache position: the decode step takes a ``[num_slots]`` tensor of
per-slot positions, so a request admitted mid-stream masks and writes at
its own position starting from 0 while older slots continue at their
depths.

HiHGNN's workload balance at the serving layer: slots are lanes, the
admission queue is the overflow-workload list, and the scheduler keeps
every lane busy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.lm.api import LMApi
from ..models.lm.attention import AttnCache
from ..models.lm.transformer import check_cache_dtype
from ..runtime import resolve_device
from ..tree import tree_leaves
from .engine import ServeState, init_serve_state

BATCHER_CACHE_DTYPE = torch.float32  # the reference's batcher builds float32 caches


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class ContinuousBatcher:
    """Fixed-slot continuous batcher (greedy decoding).

    Prompts are injected by stepping them token by token through the slot
    (prefill is the decode path), as in the reference.  The caches are
    float32, as the reference builds them, so the batcher serves the
    configs whose decode keeps the compute dtype against them: every
    float32-compute config, and mamba2 at bfloat16.  Where attention
    against float32 caches would widen a bfloat16 hidden state the
    reference's jitted step fails on its scan carry, and this one raises
    ``ValueError`` naming the cause (``transformer.check_cache_dtype``)."""

    def __init__(self, api: LMApi, num_slots: int, cache_len: int, params,
                 device: str | torch.device = "cuda"):
        check_cache_dtype(api.cfg, BATCHER_CACHE_DTYPE)
        self.api = api
        self.params = params
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.device = resolve_device(device)
        # per-slot serving state: independent caches stacked on the batch dim
        self.state = init_serve_state(api, num_slots, cache_len, dtype=BATCHER_CACHE_DTYPE,
                                      device=self.device)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int32)  # per-slot cache position
        self.slot_pending: list[list[int]] = [[] for _ in range(num_slots)]
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    def _step(self, tokens: np.ndarray, slot_pos: np.ndarray) -> np.ndarray:
        """One decode step of every slot, each at its own position: the
        greedy next token of each slot."""
        kw = {"cross_kv": self.state.cross_kv} if self.api.cfg.is_encoder_decoder else {}
        logits, caches = self.api.decode(
            self.params, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(slot_pos, device=self.device), self.state.caches, **kw)
        self.state = ServeState(caches=caches, cache_pos=self.state.cache_pos + 1,
                                cross_kv=self.state.cross_kv)
        return logits[:, 0, : self.api.cfg.vocab_size].argmax(-1).cpu().numpy()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _reset_slot(self, s: int) -> None:
        """Invalidate slot s's cache rows in place, so that a newly admitted
        request never sees the previous occupant (pos -1 is masked, K/V
        and recurrent states zeroed).  The slot dim follows the ``init_caches`` layout:
        ``caches["scan"]`` leaves are stacked ``[n_super, B, ...]`` (slot
        dim 1), ``caches["tail"]`` leaves ``[B, ...]`` (slot dim 0) —
        located by structure, not by size, so num_slots == n_super stays
        correct.  An encoder-decoder's caches are one ``AttnCache`` stacked
        ``[L, B, ...]`` (slot dim 1); the reference's batcher takes only the
        decoder's dict and fails on it with a TypeError.  Its cross K/V
        stay the placeholders, one row a slot, as the reference carries
        them."""
        caches = self.state.caches
        groups = ((caches, 1),) if isinstance(caches, AttnCache) else (
            (caches.get("scan"), 1), (caches.get("tail"), 0))
        for tree, dim in groups:
            for leaf in tree_leaves(tree):
                leaf.select(dim, s).fill_(0 if leaf.dtype.is_floating_point else -1)

    def _admit(self) -> None:
        for s in range(self.num_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self._reset_slot(s)
                self.slot_req[s] = req
                self.slot_pos[s] = 0  # a fresh request starts at its own position 0
                self.slot_pending[s] = list(req.prompt)

    def step(self) -> int:
        """One batched decode step across all slots; returns #active."""
        self._admit()
        tokens = np.zeros((self.num_slots, 1), np.int32)
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None:
                continue
            if self.slot_pending[s]:
                tokens[s, 0] = self.slot_pending[s].pop(0)
            elif req.out:
                tokens[s, 0] = req.out[-1]
            else:
                tokens[s, 0] = req.prompt[-1]
        nxt = self._step(tokens, self.slot_pos)
        active = 0
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None:
                continue
            active += 1
            self.slot_pos[s] += 1
            if not self.slot_pending[s]:  # prompt fully injected: emit
                req.out.append(int(nxt[s]))
                if req.done:
                    self.finished.append(req)
                    self.slot_req[s] = None
        return active

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
