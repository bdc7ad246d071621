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
list entry ``[i]``, joined by ``/``; None leaves (an unused ``master``, a
factored slot) do not appear.  A bfloat16 leaf is written as the
reference's numpy writes one, two raw bytes an element (``.npy`` type
``V2``) under the manifest dtype ``bfloat16``, and read back bit for bit.
Leaves are logical (unsharded) arrays, gathered over the
mesh before a write (:func:`logical_state`); :func:`reshard_to` places a
restored state on a run's device and takes this rank's slice of each leaf
on its mesh, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..dist.sharding import gather_leaf, local_slice, map_placements, param_shardings
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
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            arr, dtype = v.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        else:
            arr = v.numpy()
            dtype = str(arr.dtype)
        fname = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": k, "file": fname, "dtype": dtype, "shape": list(arr.shape)}
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


def read_leaves(ckpt_dir: str, step: int, like):
    """The checkpoint's aux, and for each leaf of ``like`` (a TrainState or
    a tree of tensors) the pair (that leaf, the file's leaf of the same key
    as a host tensor, bit for bit in the file's dtype), each file read as
    its pair is taken."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}

    def pairs():
        for k, v in tree_leaves_with_path(like):
            if k not in by_key or by_key[k]["file"] is None:
                raise KeyError(f"checkpoint {path} has no leaf {k!r}")
            arr = np.load(os.path.join(path, by_key[k]["file"]))
            if by_key[k]["dtype"] == "bfloat16":
                yield v, torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                yield v, torch.from_numpy(arr)

    return manifest["aux"], pairs()


def restore_checkpoint(ckpt_dir: str, step: int, like) -> tuple[object, dict]:
    """Restore into the structure of ``like`` (a TrainState or a tree of
    tensors): each leaf is loaded bit for bit, in the file's dtype, onto the
    device of ``like``'s leaf of the same key.  Returns (state, aux)."""
    aux, pairs = read_leaves(ckpt_dir, step, like)
    return tree_unflatten(like, [t.to(v.device) for v, t in pairs]), aux


def reshard_to(state, device: str | torch.device | None = None, *, mesh=None,
               placements=None, rules=None, axes=None):
    """Elastic restart: place a logical (restored) state on this rank.  Each
    leaf moves to ``device`` (kept where it is when None); on a ``mesh``
    each leaf is then cut to this rank's slice (``dist.local_slice``) by
    ``placements``, or by the placements ``dist.param_shardings(mesh,
    rules, axes)`` derives from a logical-axes tree (the reference's
    form).  So a checkpoint written on any mesh restores on any other: the
    leaves are logical, and the slices come from this run's mesh."""
    if device is not None:
        state = tree_unflatten(state, [x.to(device) for x in tree_leaves(state)])
    if mesh is None:
        return state
    if placements is None and rules is not None:
        placements = param_shardings(mesh, rules, axes)
    if placements is None:
        return state
    return map_placements(lambda pl, x: local_slice(x, pl, mesh), placements, state)


def logical_state(state, mesh=None, placements=None):
    """The logical form of this rank's ``state``: each leaf gathered over
    the mesh dimensions that shard it (a collective: every rank of the
    mesh calls it).  ``state`` itself without a mesh or placements."""
    if mesh is None or placements is None:
        return state
    with torch.no_grad():
        return map_placements(lambda pl, x: gather_leaf(x, pl, mesh), placements, state)


def broadcast_from_writer(mesh, device: torch.device, *, objects: list | None = None,
                          tensors=()) -> None:
    """Broadcast the writer's ``objects`` (a list, in place) and ``tensors``
    (in place) to every rank of ``mesh``: over each mesh dimension from its
    rank 0, the last dimension first, so that the writer's values reach its
    row and then every column.  ``device``: the ranks' device (objects
    travel through it on ``cuda``)."""
    for d in reversed(range(mesh.ndim)):
        if mesh.size(d) == 1:
            continue
        group = mesh.get_group(d)
        src = dist.get_global_rank(group, 0)
        if objects is not None:
            dist.broadcast_object_list(objects, src=src, group=group,
                                       device=device if device.type == "cuda" else None)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def writes_checkpoints(mesh) -> bool:
    """Whether this process writes checkpoints (and the launchers' logs):
    the only process without a mesh, the rank at coordinate 0 of every
    mesh dimension with one."""
    return mesh is None or all(mesh.get_local_rank(d) == 0 for d in range(mesh.ndim))
