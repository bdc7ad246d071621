"""Mamba2: the State Space Duality (SSD) block (Dao & Gu, 2024), the
counterpart of ``repro/models/lm/ssm.py``.

Chunked SSD: within a chunk the recurrence is computed as masked
attention-like products; across chunks a state ``[H, P, N]`` is carried by
a loop over the chunks (the reference's ``jax.lax.scan``).  Decode carries
the conv state and the SSD state, O(1) in context length.

Shapes: d_inner = expand·d_model, P = head_dim, H = d_inner / P, N = state.
The SSD state is float32; the conv state has the cache's dtype, or the
promoted type of the cache's and the compute dtype once a step has run,
as in the reference.

The reference's three-operand einsums are written as two contractions
each, in the pairing that keeps the intermediates at ``[B, nc, L, L, H]``
and ``[B, nc, L, H, P]``: ``torch.einsum`` pairs operands left to right,
and the other pairings build ``[B, nc, L, L, H, P]`` (10.7 GB a layer at
mamba2-2.7b's width, B = 2, S = 4096).

Under the ``model`` mesh axis (``ms``, a ``dist.ModelSplit``) the block
holds the ``tp`` posture's pieces: ``w_in``'s columns, ``conv_w``'s,
``conv_b``'s and ``norm``'s blocks of ``ssm_inner``, and ``w_out``'s rows.
A rank's block of ``w_in``'s 2·di + 2n + h columns cuts across ``[z, xBC,
dt]`` (:func:`_split_in`), so the block takes the "replicated" route: the
projected columns and those leaves are gathered, the recurrent core runs
whole on every rank, and each rank feeds its block of the core's output
to its ``w_out`` rows, one all-reduce after them (:func:`core_params`,
:func:`row_out`).  The states stay whole on every rank.
"""
from __future__ import annotations

import torch

from .config import LMConfig
from .layers import P, rms_norm, silu


def ssm_specs(cfg: LMConfig, *, layers: int | None = None) -> dict:
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    lead = () if layers is None else (layers,)
    lx = () if layers is None else ("layers",)
    return {
        # in_proj emits (z, x, B, C, dt)
        "w_in": P(lead + (d, 2 * di + 2 * n + h), lx + ("embed", "ssm_inner")),
        "conv_w": P(lead + (cfg.ssm_conv_width, conv_ch), lx + (None, "ssm_inner"), scale=0.3),
        "conv_b": P(lead + (conv_ch,), lx + ("ssm_inner",), init="zeros"),
        "a_log": P(lead + (h,), lx + (None,), init="zeros"),
        "dt_bias": P(lead + (h,), lx + (None,), init="zeros"),
        "d_skip": P(lead + (h,), lx + (None,), init="ones"),
        "norm": P(lead + (di,), lx + ("ssm_inner",), init="ones"),
        "w_out": P(lead + (di, d), lx + ("ssm_inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def core_params(params: dict, ms, split: dict, shared: tuple = ()) -> dict:
    """The params a recurrent core runs with: under a model split the
    ``split`` leaves (name: the dim ``model`` cuts) gathered whole, and the
    ``shared`` leaves' gradient summed over the ranks: every rank runs the
    core whole and feeds only its own block of the output on, so each
    sees a part of every leaf's gradient.  ``params`` itself with no
    ``ms``."""
    if ms is None:
        return params
    out = dict(params)
    for k, dim in split.items():
        out[k] = ms.gather(params[k], dim)
    for k in shared:
        out[k] = ms.cotangent(params[k])
    return out


def row_out(y: torch.Tensor, w_out: torch.Tensor, ms) -> torch.Tensor:
    """``y @ w_out``; under a model split, this rank's block of ``y``'s
    columns times its rows of ``w_out``, summed over the ranks."""
    if ms is None:
        return y @ w_out.to(y.dtype)
    return ms.sum(y[..., slice(*ms.block(y.shape[-1]))] @ w_out.to(y.dtype))


_CORE = {"conv_w": -1, "conv_b": -1, "norm": -1}  # the ssm_inner leaves the core reads
_SHARED = ("a_log", "dt_bias", "d_skip")


def _split_in(params, x, cfg: LMConfig, ms=None):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if ms is None:
        zxbcdt = x @ params["w_in"].to(x.dtype)
    else:  # the columns gathered: a rank's block cuts across [z, xBC, dt]
        zxbcdt = ms.gather(ms.cotangent(x) @ params["w_in"].to(x.dtype))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    return z, xbc, dt  # dt [..., H]


def depthwise_conv(u, conv_w, conv_b, state=None):
    """The causal depthwise conv1d both recurrent families share, before any
    activation.  u [B, S, C]; conv_w [W, C]; state [B, W-1, C] holds the
    trailing inputs of the previous segment (None: zero history).  The
    state and u are concatenated in their promoted type, and each tap is
    ``conv_w[i]`` cast to u's dtype, as the reference computes.  Returns
    (out [B, S, C], new state [B, W-1, C])."""
    w = conv_w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], w - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
    dt = torch.promote_types(state.dtype, u.dtype)
    padded = torch.cat([state.to(dt), u.to(dt)], dim=1)
    s = u.shape[1]
    out = sum(padded[:, i:i + s, :] * conv_w[i].to(u.dtype) for i in range(w))
    return out + conv_b.to(u.dtype), padded[:, -(w - 1):, :]


def _causal_conv(xbc, conv_w, conv_b, state=None):
    """Depthwise causal conv1d then SiLU.  xbc [B, S, C]; conv_w [W, C].
    Returns (out [B, S, C], new_state)."""
    out, new_state = depthwise_conv(xbc, conv_w, conv_b, state)
    return silu(out), new_state


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int, init_state=None):
    """SSD scan.  xh [B,S,H,P]; dt [B,S,H] (post-softplus); a [H] (< 0);
    bmat/cmat [B,S,N].  Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")

    lam = dt * a  # [B,S,H] log-decay per step (negative)
    xdt = xh * dt[..., None]  # dt-weighted inputs

    def resh(t):
        return t.reshape((b, nc, chunk) + t.shape[2:])

    lam_c, xdt_c, b_c, c_c = resh(lam), resh(xdt), resh(bmat), resh(cmat)
    cum = torch.cumsum(lam_c, dim=2)  # [B,nc,L,H] inclusive log-decay

    # intra-chunk (dual/attention form): G[t,s'] = C_t·B_s' * exp(cum_t - cum_s'), s' <= t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,L,L,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", c_c, b_c)  # [B,nc,L,L]
    # "bcts,bctsh,bcshp->bcthp": the [L, L] weights first, then the sum over s
    y_intra = torch.einsum("bctsh,bcshp->bcthp", cb[..., None] * decay, xdt_c)

    # per-chunk outgoing state: sum_s exp(cum_last - cum_s) * B_s ⊗ xdt_s
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,L,H]
    # "bcsh,bcsn,bcshp->bchpn": the decayed inputs first, then the sum over s
    states = torch.einsum("bcshp,bcsn->bchpn", decay_out[..., None] * xdt_c, b_c)

    # inter-chunk scan over the carried state: the state *entering* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    carry = init_state if init_state is not None else torch.zeros(
        (b, h, p, n), dtype=xh.dtype, device=xh.device)
    entry = []
    for c in range(nc):
        entry.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entry_states = torch.stack(entry, dim=1)  # [B,nc,H,P,N]

    # inter-chunk contribution: C_t · (entry_state decayed to t)
    decay_in = torch.exp(cum)  # [B,nc,L,H]
    # "bctn,bchpn,bcth->bcthp": the sum over n first, then the decay
    y_inter = torch.einsum("bctn,bchpn->bcthp", c_c, entry_states) * decay_in[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def ssm_forward(params, x: torch.Tensor, cfg: LMConfig, conv_state=None, ssd_state=None,
                ms=None):
    """Full-sequence mamba2 block.  x [B,S,D] -> (y, (conv_state, ssd_state)).
    ``ms``: the params are this rank's pieces (module docstring)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    z, xbc, dt = _split_in(params, x, cfg, ms)
    w_out, params = params["w_out"], core_params(params, ms, _CORE, _SHARED)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    xh = xi.reshape(x.shape[0], x.shape[1], h, p)
    dt = softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())  # [H] < 0
    chunk = min(cfg.ssm_chunk, x.shape[1])
    while x.shape[1] % chunk:  # chunk must divide the sequence length
        chunk -= 1
    y, ssd_state = _ssd_chunked(xh.float(), dt, a, bmat.float(), cmat.float(), chunk, ssd_state)
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(x.shape[0], x.shape[1], di).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    return row_out(y, w_out, ms), (conv_state, ssd_state)


def ssm_decode(params, x: torch.Tensor, cfg: LMConfig, conv_state, ssd_state, ms=None):
    """Single-token decode.  x [B,1,D]; states carried O(1) in context."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    b = x.shape[0]
    z, xbc, dt = _split_in(params, x, cfg, ms)
    w_out, params = params["w_out"], core_params(params, ms, _CORE, _SHARED)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xi, bmat, cmat = torch.split(xbc[:, 0], [di, n, n], dim=-1)
    xh = xi.reshape(b, h, p).float()
    dt = softplus(dt[:, 0].float() + params["dt_bias"].float())  # [B,H]
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)  # [B,H]
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], bmat.float())
    ssd_state = ssd_state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), ssd_state)
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    return row_out(y, w_out, ms), (conv_state, ssd_state)


def init_ssm_cache(cfg: LMConfig, batch: int, dtype, device):
    """(conv [B, W-1, d_inner + 2N] in ``dtype``, ssd [B, H, P, N] float32)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device)
    ssd = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    return conv, ssd
