"""Device meshes of the launchers (the counterpart of ``repro.launch.mesh``):
``torch.distributed`` device meshes with named dimensions, the ``lane``
axis over which ``core.multilane.multilane_na_sharded`` splits a plan's
lanes (paper §4.2.1), the ``model`` axis over which the ``dist`` rules
shard head and feature dims (``dist.sharding.make_rules(
parallelism="lanes")``), and the ``data`` axis over which the LM trainer
splits its batch (:func:`make_data_mesh`).

A mesh is made from an initialised process group of as many ranks as it
has (``torchrun --nproc-per-node N`` sets one up for the launchers; a test
gives ``init_process_group`` its address, world size and rank; a dry run
brings up the ``fake`` backend's group of the production mesh's 256 or
512 ranks in one process).  One rank is the one-process path and needs no
group.
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


def _production_shape(multi_pod: bool) -> tuple[int, ...]:
    """16 × 16 = 256 ranks a pod; ``multi_pod`` adds a leading 2-pod axis (512)."""
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production geometry: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` with ``"pod"`` in front, over whatever
    process group of 256 (512) ranks is set up: NCCL on a cluster, the
    ``fake`` backend in a dry run (:func:`make_mesh`)."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(_production_shape(multi_pod), axes, device_type=device_type)


def make_lane_mesh(lanes: int | None = None, model: int | None = None, *,
                   multi_pod: bool = False, device_type: str = "cuda"):
    """The ``(lane, model)`` mesh of ``lanes · model`` ranks
    (:func:`make_mesh`), or None at (1, 1), the one-process path.  With no
    sizes, the production geometry over ``("lane", "model")``: 16 lane
    groups × 16 model ranks a pod; ``multi_pod`` puts a 2-pod axis in
    front, as the reference's (``("pod", "lane", "model")``).  Raises where
    no process group of that many ranks is set up."""
    if lanes is None and model is None:
        shape = _production_shape(multi_pod)
    else:
        lanes, model = (1 if v is None else v for v in (lanes, model))
        if lanes < 1 or model < 1:
            raise ValueError(f"mesh sizes must be >= 1, got lanes={lanes}, model={model}")
        shape = ((2,) if multi_pod else ()) + (lanes, model)
    if len(shape) == 2 and shape[0] * shape[1] == 1:
        return None
    axes = ("pod", "lane", "model") if len(shape) == 3 else ("lane", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_data_mesh(n: int, *, device_type: str = "cuda"):
    """The LM trainer's ``(n, 1)`` mesh over ``("data", "model")``: the batch
    split over ``data``, every parameter replicated (the reference's
    ``make_rules(batch_shard=True, fsdp=False)`` on it), or None at one
    rank, the one-process path."""
    if n < 1:
        raise ValueError(f"data mesh size must be >= 1, got {n}")
    if n == 1:
        return None
    return make_mesh((n, 1), ("data", "model"), device_type=device_type)
