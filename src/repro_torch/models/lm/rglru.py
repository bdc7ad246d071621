"""RG-LRU recurrent block (RecurrentGemma / Griffin, De et al. 2024), the
counterpart of ``repro/models/lm/rglru.py``.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (diagonal decay, a_t in (0,1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ x_t)

The full sequence runs the linear recurrence as an inclusive scan of the
reference's ``combine`` by Hillis–Steele doubling: log2(S) elementwise
passes over the sequence axis, where the reference runs
``jax.lax.associative_scan``.  The two scans add in different orders, so
the port agrees with the reference to float32 rounding, not bit for bit.
Decode is an O(1) step.

Under the ``model`` mesh axis (``ms``, a ``dist.ModelSplit``) the block
holds the ``tp`` posture's pieces of ``rnn``: ``w_x``'s and ``w_y``'s
columns, ``w_a``'s and ``w_i``'s rows (their products mix every channel),
the conv's, gates' biases' and ``lam``'s blocks, and ``w_out``'s rows.
It takes the "replicated" route (``ssm.core_params``): the projected
``w_x`` columns and the core's leaves are gathered, the conv, gates and
scan run whole on every rank, and each rank multiplies its block of ``h``
by its own ``w_y`` columns' gate and feeds it to its ``w_out`` rows, one
all-reduce after them.  The states stay whole on every rank.
"""
from __future__ import annotations

import torch

from .config import LMConfig
from .layers import P, gelu_tanh
from .ssm import core_params, depthwise_conv, softplus


def rglru_specs(cfg: LMConfig, *, layers: int | None = None) -> dict:
    d = cfg.d_model
    rw = cfg.rnn_width or d
    lead = () if layers is None else (layers,)
    lx = () if layers is None else ("layers",)
    return {
        "w_x": P(lead + (d, rw), lx + ("embed", "rnn")),       # recurrent branch in
        "w_y": P(lead + (d, rw), lx + ("embed", "rnn")),       # gate branch in
        "conv_w": P(lead + (cfg.ssm_conv_width, rw), lx + (None, "rnn"), scale=0.3),
        "conv_b": P(lead + (rw,), lx + ("rnn",), init="zeros"),
        "w_a": P(lead + (rw, rw), lx + ("rnn", None), scale=0.01),
        "b_a": P(lead + (rw,), lx + ("rnn",), init="zeros"),
        "w_i": P(lead + (rw, rw), lx + ("rnn", None), scale=0.01),
        "b_i": P(lead + (rw,), lx + ("rnn",), init="zeros"),
        "lam": P(lead + (rw,), lx + ("rnn",), init="ones"),    # Lambda
        "w_out": P(lead + (rw, d), lx + ("rnn", "embed")),
    }


def _gates(params, u, cfg: LMConfig):
    """u [.., rw] (post-conv) -> (a, gated input) in float32: two float32
    rw × rw products a token."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(uf @ params["w_i"].float() + params["b_i"].float())
    log_a = -cfg.rglru_c * softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (i * uf)
    return a, b


def _conv(params, u, state):
    return depthwise_conv(u, params["conv_w"], params["conv_b"], state)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t from h_{-1} = 0 along axis 1: the inclusive
    scan of ``combine((a1, b1), (a2, b2)) = (a1·a2, b1·a2 + b2)``, as
    log2(S) doubling passes, each combining every position with the one
    ``d`` before it."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < s:  # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


# the rnn leaves the conv and the gates read (name: the dim ``model`` cuts)
_CORE = {"conv_w": -1, "conv_b": -1, "w_a": 0, "b_a": -1, "w_i": 0, "b_i": -1, "lam": -1}


def _inputs(params, x: torch.Tensor, ms):
    """(u, gate): the recurrent branch's input, whole, and the gate branch,
    this rank's columns under ``ms``."""
    if ms is not None:
        x = ms.cotangent(x)
    u = x @ params["w_x"].to(x.dtype)
    return (u if ms is None else ms.gather(u)), gelu_tanh(x @ params["w_y"].to(x.dtype))


def _out(params, h: torch.Tensor, gate: torch.Tensor, ms) -> torch.Tensor:
    """``(h · gate) @ w_out``; under ``ms``, this rank's block of ``h`` (its
    gate's columns) times its ``w_out`` rows, summed over the ranks."""
    if ms is not None:
        h = h[..., slice(*ms.block(h.shape[-1]))]
    y = (h.to(gate.dtype) * gate) @ params["w_out"].to(gate.dtype)
    return y if ms is None else ms.sum(y)


def rglru_forward(params, x: torch.Tensor, cfg: LMConfig, conv_state=None, h_state=None,
                  ms=None):
    """x [B,S,D] -> (y [B,S,D], (conv_state, h_state)); ``ms``: the params
    are this rank's pieces (module docstring)."""
    u, gate = _inputs(params, x, ms)
    core = core_params(params, ms, _CORE)
    u, conv_state = _conv(core, u, conv_state)
    a, bterm = _gates(core, u, cfg)  # [B,S,rw] float32
    if h_state is not None:
        # fold the carried state into the first step's additive term
        bterm = torch.cat([bterm[:, :1] + a[:, :1] * h_state.float()[:, None], bterm[:, 1:]],
                          dim=1)
    h = linear_scan(a, bterm)
    h_state = h[:, -1, :]
    return _out(params, h, gate, ms), (conv_state, h_state)


def rglru_decode(params, x: torch.Tensor, cfg: LMConfig, conv_state, h_state, ms=None):
    """x [B,1,D] single step."""
    u, gate = _inputs(params, x, ms)
    core = core_params(params, ms, _CORE)
    u, conv_state = _conv(core, u, conv_state)
    a, bterm = _gates(core, u, cfg)
    h = a[:, 0] * h_state.float() + bterm[:, 0]
    return _out(params, h[:, None, :], gate, ms), (conv_state, h)


def init_rglru_cache(cfg: LMConfig, batch: int, dtype, device):
    """(conv [B, W-1, rw] in ``dtype``, h [B, rw] float32)."""
    rw = cfg.rnn_width or cfg.d_model
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, rw), dtype=dtype, device=device)
    h = torch.zeros((batch, rw), dtype=torch.float32, device=device)
    return conv, h
