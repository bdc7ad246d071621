"""The lane mesh of multi-lane execution (the counterpart of
``repro.launch.mesh.make_lane_mesh``): a ``torch.distributed`` device mesh
with a ``lane`` axis, over which ``core.multilane.multilane_na_sharded``
splits a plan's lanes (paper §4.2.1), and a ``model`` axis.

The mesh is made from an initialised process group of ``lanes · model``
ranks (``torchrun --nproc-per-node N`` sets one up for the launchers; a
test gives ``init_process_group`` its address, world size and rank).  One
lane and one model rank is the one-process path and needs no group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 9 (the model mesh axis: the dist sharding rules)"


def make_lane_mesh(lanes: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """``init_device_mesh(device_type, (lanes, model), mesh_dim_names=("lane",
    "model"))`` over the initialised process group, or None at (1, 1).  On
    ``cuda`` each rank first takes its own card (``LOCAL_RANK``, which
    torchrun sets, else its rank modulo the cards).

    Raises where no process group of ``lanes · model`` ranks is set up, and
    ``NotImplementedError`` for ``model > 1``: the reference shards heads
    and features over that axis through its ``dist`` rules, which the port
    does not have yet."""
    if lanes < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got lanes={lanes}, model={model}")
    if model > 1:
        raise NotImplementedError(f"a model axis of {model} is not ported yet: {MODEL_AXIS_ITEM}")
    if lanes == 1:
        return None
    n = lanes * model
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a lane mesh of {lanes} x {model} needs a torch.distributed process group of {n} "
            f"ranks, and none is initialised: launch one process per rank, e.g. "
            f"`torchrun --nproc-per-node {n} -m repro_torch.launch.hgnn_train --lanes {lanes}`")
    if dist.get_world_size() != n:
        raise ValueError(f"a lane mesh of {lanes} x {model} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    if device_type == "cuda":  # one card a rank: the launcher's local rank, else rank mod cards
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank() % torch.cuda.device_count())))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (lanes, model), mesh_dim_names=("lane", "model"))
