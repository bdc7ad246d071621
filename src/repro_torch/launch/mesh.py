"""Device meshes of the launchers (the counterpart of ``repro.launch.mesh``):
``torch.distributed`` device meshes with named dimensions, the ``lane``
axis over which ``core.multilane.multilane_na_sharded`` splits a plan's
lanes (paper §4.2.1) and the ``model`` axis over which the ``dist``
rules shard head and feature dims (``dist.sharding.make_rules(
parallelism="lanes")``).

A mesh is made from an initialised process group of as many ranks as it
has (``torchrun --nproc-per-node N`` sets one up for the launchers; a test
gives ``init_process_group`` its address, world size and rank).  One lane
and one model rank is the one-process path and needs no group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type: str = "cuda"):
    """``init_device_mesh(device_type, shape, mesh_dim_names=axes)`` over the
    initialised process group, which must have ``prod(shape)`` ranks.  On
    ``cuda`` each rank first takes its own card (``LOCAL_RANK``, which
    torchrun sets, else its rank modulo the cards)."""
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} and axes {axes}: one size >= 1 an axis")
    n = math.prod(shape)
    desc = " x ".join(f"{a} {s}" for a, s in zip(axes, shape))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {desc} needs a torch.distributed process group of {n} ranks, and "
            f"none is initialised: launch one process per rank, e.g. `torchrun "
            f"--nproc-per-node {n} -m repro_torch.launch.hgnn_train ...`")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {desc} needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":  # one card a rank: the launcher's local rank, else rank mod cards
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank() % torch.cuda.device_count())))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_lane_mesh(lanes: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """The ``(lane, model)`` mesh of ``lanes · model`` ranks
    (:func:`make_mesh`), or None at (1, 1), the one-process path.  Raises
    where no process group of ``lanes · model`` ranks is set up."""
    if lanes < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got lanes={lanes}, model={model}")
    if lanes * model == 1:
        return None
    return make_mesh((lanes, model), ("lane", "model"), device_type=device_type)
