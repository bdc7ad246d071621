"""Carry JAX weights and train state across to the port.

The two frameworks' random streams never match, so parity between
``repro`` and ``repro_torch`` is held on the SAME weights, passed through
numpy::

    params = jax.tree.map(np.asarray, jax_engine.params)
    mp = {k: tuple(np.asarray(a) for a in v) for k, v in jax_engine._mp_params.items()}
    port = HGNNEngine(graph, ..., **engine_params_from_numpy(params, mp, device="cuda"))

    params = jax.tree.map(np.asarray, repro.models.hgnn.init_rgat(key, data))
    port_params = params_from_numpy(params, device="cuda")
    state = train_state_from_numpy(params, jax.tree.map(np.asarray, opt), step)

    params = jax.tree.map(np.asarray, repro.models.lm.api.build(cfg).init(key))
    lm_params = lm_params_from_numpy(params, device="cuda")   # dtypes kept

    st = repro.train.step.init_train_state(api, key, opt_cfg)
    lm_state = lm_train_state_from_numpy(*(jax.tree.map(np.asarray, t)
                                           for t in (st.params, st.opt, st.step)))

This module imports nothing of JAX: it takes numpy arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _tensor_keep_dtype(a, device) -> torch.Tensor:
    """``a`` as a tensor of its own dtype.  A bfloat16 array (numpy holds it
    as ``ml_dtypes.bfloat16``, which torch cannot read) crosses bit for bit
    as int16 viewed as ``torch.bfloat16``."""
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(params, device: str | torch.device = "cuda"):
    """An LM params tree given as numpy (``params["scan"]["pos0"]["attn"]
    ["wq"]`` …) as the same tree of tensors on ``device``, each leaf in its
    own dtype: float32 stays float32, bfloat16 stays bfloat16."""
    return tree_map(lambda a: _tensor_keep_dtype(a, device), params)


def lm_train_state_from_numpy(params, opt: Mapping, step, device: str | torch.device = "cuda"):
    """A reference LM ``TrainState`` given as numpy, as the port's, every
    leaf in its own dtype: the params (bf16 leaves bit for bit), the AdamW
    state of any mode (``m``/``v`` in their moment dtype, or the factored
    ``v_row``/``v_col``/``v_full``; ``master``), its None slots kept, and
    the int32 ``count`` and step."""
    from .train.step import TrainState

    scalar = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=device)  # noqa: E731
    return TrainState(
        params=lm_params_from_numpy(params, device),
        opt={k: scalar(v) if k == "count" else lm_params_from_numpy(v, device)
             for k, v in opt.items()},
        step=scalar(step),
    )


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


def params_from_numpy(params, device: str | torch.device = "cuda"):
    """Any JAX params tree given as numpy — nested dicts and lists, e.g.
    R-GAT's ``params["layers"][l]["rel"]["g0"]["w_src"]`` — as the same
    tree of float32 tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), params)


def train_state_from_numpy(
    params, opt: Mapping, step, device: str | torch.device = "cuda"
):
    """A reference ``TrainState`` (params, AdamW state ``m``/``v``/
    ``master``/``count``, step) given as numpy, as the port's
    ``TrainState``.  The trees may nest; ``master`` mirrors the params
    with None leaves (float32 params keep no master copy)."""
    from .train.step import TrainState

    return TrainState(
        params=params_from_numpy(params, device),
        opt={
            "m": params_from_numpy(opt["m"], device),
            "v": params_from_numpy(opt["v"], device),
            "master": tree_map(lambda _: None, params),
            "count": torch.tensor(np.asarray(opt["count"]), dtype=torch.int32, device=device),
        },
        step=torch.tensor(np.asarray(step), dtype=torch.int32, device=device),
    )
