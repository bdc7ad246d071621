"""Kernel #7 (flash attention): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its dense oracle.

The inputs are made with numpy from a seed and cast to each framework's
dtype (bfloat16 rounds to nearest even in both, so both see the same
bits).  Tolerances are ``tests/test_kernels.py``'s ``TOL``: float32 3e-5
(sum order), bfloat16 3e-2 (one rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import ref_flash_attention
from repro_torch.kernels import flash_attention, flash_attention_plain

TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
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
    with pytest.raises(NotImplementedError, match="no gradient"):
        flash_attention(q.requires_grad_(), k, v)
