"""Carry a JAX ``repro.serve.HGNNEngine``'s weights across to the port.

The two frameworks' random streams never match, so parity between
``repro`` and ``repro_torch`` is held on the SAME weights, passed through
numpy::

    params = jax.tree.map(np.asarray, jax_engine.params)
    mp = {k: tuple(np.asarray(a) for a in v) for k, v in jax_engine._mp_params.items()}
    port = HGNNEngine(graph, ..., **engine_params_from_numpy(params, mp, device="cuda"))

This module imports nothing of JAX: it takes numpy arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def engine_params_from_numpy(
    params: Mapping,
    metapath_params: Mapping[tuple[str, ...], tuple],
    device: str | torch.device = "cuda",
) -> dict:
    """``params`` holds ``w_fp``/``b_fp`` (per vertex type), ``w_g``,
    ``b_g`` and ``q``; ``metapath_params`` maps each metapath to its
    ``(a_src, a_dst)``.  Returns the ``params=`` and ``metapath_params=``
    keywords of ``repro_torch.serve.HGNNEngine``, as float32 tensors on
    ``device``."""
    return dict(
        params={
            "w_fp": {t: _tensor(v, device) for t, v in params["w_fp"].items()},
            "b_fp": {t: _tensor(v, device) for t, v in params["b_fp"].items()},
            "w_g": _tensor(params["w_g"], device),
            "b_g": _tensor(params["b_g"], device),
            "q": _tensor(params["q"], device),
        },
        metapath_params={
            tuple(mp): (_tensor(a_src, device), _tensor(a_dst, device))
            for mp, (a_src, a_dst) in metapath_params.items()
        },
    )
