"""Checkpointing in the reference's on-disk layout (``repro.checkpoint.io``).

Layout: ``<dir>/step_<n>/`` with one ``.npy`` per leaf and a
``manifest.json`` (step, aux state such as the data-pipeline counters, and
per leaf its key, file, dtype and shape).  Writes go to a tmp dir and an
atomic ``os.replace``: a crash mid-write never corrupts the latest
checkpoint.

Leaf keys are JAX's tree-path strings (``tree.tree_leaves_with_path``),
so a checkpoint of either package restores into the other: a field of a
dataclass such as ``TrainState`` is ``[<flat index i>]`` (params, opt,
step in order), a dict entry ``['name']`` with keys in sorted order, a
list entry ``[i]``, joined by ``/``; None leaves (an unused ``master``) do
not appear.  Leaves are logical (unsharded) arrays; :func:`reshard_to`
places a restored state on a run's device and lane group, whatever lane
count wrote it.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_leaves_with_path, tree_unflatten


def save_checkpoint(ckpt_dir: str, step: int, state, aux: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "aux": aux or {}, "leaves": []}
    for i, (k, v) in enumerate(tree_leaves_with_path(state)):
        arr = v.detach().cpu().numpy()
        fname = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": k, "file": fname, "dtype": str(arr.dtype), "shape": list(arr.shape)}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like) -> tuple[object, dict]:
    """Restore into the structure of ``like`` (a TrainState or a tree of
    tensors): each leaf is loaded bit for bit, in the file's dtype, onto the
    device of ``like``'s leaf of the same key.  Returns (state, aux)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    values = []
    for k, v in tree_leaves_with_path(like):
        if k not in by_key or by_key[k]["file"] is None:
            raise KeyError(f"checkpoint {path} has no leaf {k!r}")
        arr = np.load(os.path.join(path, by_key[k]["file"]))
        values.append(torch.from_numpy(arr).to(v.device))
    return tree_unflatten(like, values), manifest["aux"]


def reshard_to(state, device: str | torch.device | None = None, *, mesh=None):
    """Elastic restart: place a restored (host) state on this run's device,
    replicated over the lane group of ``mesh`` (``launch.mesh.make_lane_mesh``).

    Under the lanes posture every rank holds the whole state (params and
    optimizer state are replicated; the multi-lane plan is rebuilt per
    run), so a checkpoint written at L lanes restores bit-identically at
    any L′: each leaf moves to ``device`` (kept where it is when None) and,
    with a mesh, lane rank 0's copy is broadcast over the lane group, so
    every rank starts from the same bits.  Only lane rank 0 reads and
    writes checkpoints (``train.loop.train_loop``)."""
    if device is not None:
        state = tree_unflatten(state, [x.to(device) for x in tree_leaves(state)])
    if mesh is not None:
        group = mesh.get_group("lane")
        src = dist.get_global_rank(group, 0)
        for leaf in tree_leaves(state):
            dist.broadcast(leaf, src=src, group=group)
    return state


def writes_checkpoints(mesh) -> bool:
    """Whether this process writes checkpoints: the only process without a
    mesh, lane rank 0 with one."""
    return mesh is None or dist.get_rank(mesh.get_group("lane")) == 0
