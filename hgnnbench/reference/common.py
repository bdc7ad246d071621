"""Plain PyTorch pieces the references share: products in a stated
precision, Glorot weights drawn from the seed, the cross-entropy of a
full batch, and AdamW with a global-norm clip.

Nothing here imports the port.  Every float32 product goes through
:func:`mm` or :func:`einsum`; ``precision="tf32"`` runs them in TF32 (the
control of the benchmark's comparison): on the card with TF32 switched on
for that product, on the CPU by rounding both operands to TF32's 10-bit
mantissa first.
"""
from __future__ import annotations

import contextlib
import math

import torch

_PRECISION = ["float32"]


@contextlib.contextmanager
def precision(name: str):
    """Products inside run in ``name`` ("float32" or "tf32")."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"precision {name!r}")
    old = _PRECISION[0]
    _PRECISION[0] = name
    try:
        yield
    finally:
        _PRECISION[0] = old


def float32_matmuls() -> None:
    """TF32 off for every product (the configurations state float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (1 + 8 + 10 bits), to nearest, ties away; the
    gradient passes the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def _product_mode(device: torch.device):
    tf32 = _PRECISION[0] == "tf32"
    if device.type != "cuda":
        yield tf32
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _product_mode(a.device) as emulate:
        if emulate:
            a, b = _tf32(a), _tf32(b)
        return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _product_mode(a.device) as emulate:
        if emulate:
            a, b = _tf32(a), _tf32(b)
        return torch.einsum(eq, a, b)


def glorot(flat: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Glorot-uniform weights of ``shape`` from uniform [-1, 1) draws."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (flat.reshape(shape) * lim).contiguous()


def draw(shapes: dict[str, tuple[int, ...]], gen: torch.Generator, device,
         zero: tuple[str, ...] = ()) -> dict:
    """Glorot weights of every named shape (those named in ``zero`` are
    zeros), from ONE uniform draw on ``device`` cut in the order given."""
    sizes = {k: math.prod(s) for k, s in shapes.items() if k not in zero}
    flat = torch.rand(sum(sizes.values()), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for k, s in shapes.items():
        if k in zero:
            out[k] = torch.zeros(s, device=device)
            continue
        out[k] = glorot(flat[at:at + sizes[k]], s)
        at += sizes[k]
    return out


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def adamw(params: dict, grads: dict, state: dict, opt: dict) -> tuple[dict, dict]:
    """One AdamW step over flat dicts of leaves: the global norm of the
    gradient clipped to ``grad_clip``, then bias-corrected moments and a
    decoupled weight decay.  Returns (params, state), new dicts."""
    sq = sum(torch.sum(g.double() ** 2) for g in grads.values())
    scale = min(1.0, opt["grad_clip"] / max(float(torch.sqrt(sq)), 1e-9))
    t = state["count"] + 1
    c1, c2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    new_p, m, v = {}, {}, {}
    for k, p in params.items():
        g = grads[k] * scale
        m[k] = opt["b1"] * state["m"][k] + (1 - opt["b1"]) * g
        v[k] = opt["b2"] * state["v"][k] + (1 - opt["b2"]) * g * g
        step = (m[k] / c1) / (torch.sqrt(v[k] / c2) + opt["eps"]) + opt["weight_decay"] * p
        new_p[k] = p - opt["lr"] * step
    return new_p, {"m": m, "v": v, "count": t}


def adamw_state(params: dict) -> dict:
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    return {"m": zeros, "v": {k: torch.zeros_like(p) for k, p in params.items()}, "count": 0}
