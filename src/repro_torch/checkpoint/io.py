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
not appear.  Leaves are logical (unsharded) arrays.  Placing them onto a
lane mesh (``reshard_to``) waits for the multi-lane slice.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..tree import tree_leaves_with_path, tree_unflatten


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
