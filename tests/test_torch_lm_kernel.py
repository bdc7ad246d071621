"""Kernel #7 (flash attention): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its dense oracle; the
routing rule between the two CUDA kernels; and a CPU emulation of the
tensor-core route's numerics against the Pallas kernel.

The inputs are made with numpy from a seed and cast to each framework's
dtype (bfloat16 rounds to nearest even in both, so both see the same
bits).  Tolerances are ``tests/test_kernels.py``'s ``TOL``: float32 3e-5
(sum order), bfloat16 3e-2 (one rounding of the output); the tensor-core
emulation in bfloat16 at ``ONE_ROUNDING`` (atol=1e-4, rtol=8e-3: the
float32 results agree to about 1e-6, so the bf16 outputs differ by at most
one rounding, 2^-8 relative)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import ref_flash_attention
from repro_torch.kernels import flash_attention, flash_attention_plain

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ONE_ROUNDING = dict(atol=1e-4, rtol=8e-3)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# tests/test_kernels.py:test_flash_attention_sweep
SWEEP = [
    (2, 4, 2, 32, 32, 16, True, None),
    (1, 4, 4, 16, 48, 16, True, None),   # Sq != Sk (continuation)
    (1, 2, 1, 32, 32, 16, True, 8),      # MQA + local window
    (1, 2, 2, 32, 32, 16, False, None),  # bidirectional (encoder)
    (2, 8, 2, 64, 64, 32, True, None),
]


def _operands(B, Hq, Hkv, Sq, Sk, Dh, dtype):
    rng = np.random.default_rng(Sq + Sk)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh))]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window", SWEEP)
def test_flash_plain_matches_pallas_and_ref(dtype, B, Hq, Hkv, Sq, Sk, Dh, causal, window):
    (q, k, v), (tq, tk, tv) = _operands(B, Hq, Hkv, Sq, Sk, Dh, dtype)
    want = jax_flash(q, k, v, causal=causal, window=window, block_q=16, block_k=16,
                     interpret=True)
    ref = ref_flash_attention(q, k, v, causal=causal, window=window)
    got = flash_attention(tq, tk, tv, causal=causal, window=window, block_q=16, block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])
    torch.testing.assert_close(flash_attention_plain(tq, tk, tv, causal=causal, window=window),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_rows_with_no_visible_key_are_exact_zeros(dtype):
    """Sq > Sk under ``causal``: the first Sq - Sk rows see no key; the
    Pallas kernel divides a zero accumulator by max(l, 1e-9)."""
    B, Hq, Hkv, Sq, Sk, Dh = 1, 2, 1, 48, 16, 16
    (q, k, v), (tq, tk, tv) = _operands(B, Hq, Hkv, Sq, Sk, Dh, dtype)
    want = jax_flash(q, k, v, causal=True, block_q=16, block_k=16, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert (got[:, :, : Sq - Sk] == 0).all()
    assert (np.asarray(want, np.float32)[:, :, : Sq - Sk] == 0).all()
    assert (got[:, :, Sq - Sk:] != 0).any(dim=-1).all()


@pytest.mark.parametrize("Dh,window", [(128, None), (256, 8)])
def test_flash_plain_matches_pallas_at_wide_heads(Dh, window):
    """The configs' head widths (llama/qwen 128; recurrentgemma 256 with
    MQA and a local window) at small S."""
    (q, k, v), (tq, tk, tv) = _operands(1, 4, 1 if window else 2, 32, 32, Dh, "float32")
    want = jax_flash(q, k, v, causal=True, window=window, block_q=16, block_k=16,
                     interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, window=window, block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_flash_wrapper_keeps_the_reference_preconditions():
    _, (q, k, v) = _operands(1, 4, 2, 48, 48, 16, "float32")
    with pytest.raises(ValueError, match="multiples of the blocks"):
        flash_attention(q, k, v, block_q=32, block_k=32)   # 48 % 32 != 0, as the reference asserts
    with pytest.raises(ValueError, match="not a multiple of Hkv"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.double(), v)
    with pytest.raises(NotImplementedError, match='no gradient.*training runs impl="xla"'):
        flash_attention(q.requires_grad_(), k, v)


# -- the two routes on the card -------------------------------------------------


@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 8, "cuda_cores"), (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores"), (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 256, "cuda_cores"),
])
def test_flash_route_by_dtype_and_head_width(dtype, Dh, want):
    assert fa_mod.route(dtype, Dh) == want


def test_flash_shared_memory_check_reads_each_routes_layout(monkeypatch):
    """wgmma: bf16 Q [128][Dh] + 2 stages of K and V [128][Dh] + 7 mbarriers
    + 1 KiB of alignment; cuda_cores: float32 q, K/V and p tiles of 64."""
    assert fa_mod.smem_bytes(128, "wgmma") == 2 * 128 * (128 + 4 * 128) + 8 * 7 + 1024
    assert fa_mod.smem_bytes(64, "wgmma") == 2 * 64 * (128 + 4 * 128) + 8 * 7 + 1024
    assert fa_mod.smem_bytes(128, "cuda_cores") == 87_040
    for dh in fa_mod.HEAD_DIMS:
        assert fa_mod.smem_bytes(dh, fa_mod.route(torch.bfloat16, dh)) <= fa_mod.SMEM_OPTIN
    with pytest.raises(ValueError, match="unknown route"):
        fa_mod.smem_bytes(128, "tensor")
    # a limit between the two layouts at Dh = 128: only the wgmma route is refused
    monkeypatch.setattr(fa_mod, "SMEM_OPTIN", 100_000)
    assert fa_mod.card_route(torch.float32, 128) == "cuda_cores"
    with pytest.raises(ValueError, match="on the wgmma route needs 164920 B"):
        fa_mod.card_route(torch.bfloat16, 128)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa_mod.card_route(torch.bfloat16, 48)


# -- the tensor-core route's numerics, emulated on the CPU ------------------------


@pytest.mark.parametrize("block_k", [16, 128])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window", SWEEP)
def test_tensor_core_numerics_match_pallas(B, Hq, Hkv, Sq, Sk, Dh, causal, window, block_k):
    """The emulation in bf16 against the Pallas kernel (interpret mode) at
    the sweep's shapes, within one bf16 rounding."""
    (q, k, v), (tq, tk, tv) = _operands(B, Hq, Hkv, Sq, Sk, Dh, "bfloat16")
    want = jax_flash(q, k, v, causal=causal, window=window, block_q=16, block_k=16,
                     interpret=True)
    got = fa_mod.tensor_core_emulation(tq, tk, tv, causal=causal, window=window, block_k=block_k)
    np.testing.assert_allclose(_np(got.bfloat16()), _np(want), **ONE_ROUNDING)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window",
                         SWEEP + [(1, 4, 2, 256, 256, 128, True, None)])
def test_tensor_core_split_of_p_keeps_float32_fidelity(B, Hq, Hkv, Sq, Sk, Dh, causal, window):
    """Why p is split: against the float32 ``flash_attention_plain`` of the
    same bf16 operands, one bf16 rounding of p lands at least 10x further
    off than ``p_hi + p_lo`` (float32 outputs, before the final cast)."""
    _, (tq, tk, tv) = _operands(B, Hq, Hkv, Sq, Sk, Dh, "bfloat16")
    ref = flash_attention_plain(tq.float(), tk.float(), tv.float(), causal=causal, window=window)
    split = fa_mod.tensor_core_emulation(tq, tk, tv, causal=causal, window=window)
    single = fa_mod.tensor_core_emulation(tq, tk, tv, causal=causal, window=window, split=False)
    err_split = float((split - ref).abs().max())
    err_single = float((single - ref).abs().max())
    assert err_single >= 10 * err_split, (err_single, err_split)
    np.testing.assert_allclose(split.numpy(), ref.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window",
                         SWEEP + [(1, 4, 2, 256, 256, 128, True, None)])
def test_bitwise_share_limit_separates_split_from_single_rounding(
        B, Hq, Hkv, Sq, Sk, Dh, causal, window):
    """The card's check on the wgmma route: the split emulation's bf16
    outputs equal the one rounding of the float32 result at least
    ``BITWISE_SHARE_MIN`` of the time, p rounded once to bf16 falls below."""
    _, (tq, tk, tv) = _operands(B, Hq, Hkv, Sq, Sk, Dh, "bfloat16")
    want = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    share = {split: float((fa_mod.tensor_core_emulation(
        tq, tk, tv, causal=causal, window=window, split=split).bfloat16() == want).float().mean())
        for split in (True, False)}
    assert share[True] >= fa_mod.BITWISE_SHARE_MIN > share[False], share
