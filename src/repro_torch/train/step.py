"""The train state shared by the trainers (``repro.train.step.TrainState``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    params: Any          # a tree of tensors (repro_torch.tree)
    opt: Any             # the optimizer state (optim.adamw layout)
    step: torch.Tensor   # int32 scalar
