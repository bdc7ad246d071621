"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, each number beside its limit.

Training (three full-batch steps the window's own call made):
    loss_gap    the largest |L_prog - L_ref| / |L_ref| over the steps;
    grad_gap    the worst leaf's | |g_prog| - |g_ref| | over the larger of
                |g_ref| of that leaf and of the median leaf, g the first
                step's gradient as AdamW took it (its first moment / (1 - b1));
    change_gap  the same of the params' change over the three steps, over
                the leaves whose reference gradient is at least a
                thousandth of the median leaf's (a leaf with none moves
                under AdamW by round-off alone).
Inference:
    logit_gap   the largest |logit_prog - logit_ref| over the largest
                |logit_ref|, over the forwards kept from the window.
"""
from __future__ import annotations

import statistics

import torch

MOVES_MIN = 1e-3  # a leaf moves by its gradient when |g_ref| >= this x the median leaf's


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _worst_leaf(prog: dict, ref: dict, keys) -> float:
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    floor = statistics.median(rn.values()) if rn else 0.0
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in keys]
    return max(gaps, default=0.0)


def train_numbers(prog: dict, ref: dict, params0: dict) -> dict:
    """``prog`` and ``ref``: {"losses", "grads", "params"} (flat dicts,
    the reference's names)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    keys = list(ref["grads"])
    gref = _norms(ref["grads"])
    floor = statistics.median(gref.values())
    moving = [k for k in keys if gref[k] >= MOVES_MIN * floor]
    dprog = {k: prog["params"][k].to(params0[k].device) - params0[k] for k in moving}
    dref = {k: ref["params"][k] - params0[k] for k in moving}
    return {"loss_gap": max(losses),
            "grad_gap": _worst_leaf(prog["grads"], ref["grads"], keys),
            "change_gap": _worst_leaf(dprog, dref, moving)}


def logit_gap(outputs: list, ref: torch.Tensor) -> float:
    scale = float(ref.abs().max())
    return max(float((o.to(ref.device) - ref).abs().max()) / scale for o in outputs)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict, int]:
    """(correct, {name: {"value", "limit"}}, failed): every number at or
    under its limit; a number that is not finite fails."""
    out, failed = {}, 0
    for name, value in numbers.items():
        limit = limits[name]
        ok = value == value and value <= limit
        failed += not ok
        out[name] = {"value": value, "limit": limit}
    return failed == 0, out, failed
