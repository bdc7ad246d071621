"""The port's VLM path (qwen2-vl-7b: M-RoPE and visual embeddings) against
the JAX package's: ``mrope_angles`` bit for bit, the smoke forward with
``visual_embeds`` and explicit ``[B, S, 3]`` positions on "xla" and
"flash" (JAX's flash path runs the Pallas kernel in interpret mode, the
port's the plain version of kernel #7), decode against the forward, and
greedy tokens.

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``
(constant leaves, the QKV biases this family sets among them, get noise);
inputs from numpy.  Tolerances: float32 compute 1e-5 (sum order),
bfloat16 compute 3e-2 (``tests/test_torch_lm_model.py``'s); decode ==
forward 5e-4, as ``tests/test_decode_equivalence.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import layers as jlayers
from repro.models.lm.api import build as jbuild
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import engine as tengine
from test_torch_lm_model import TOL, as_np, shared_params

ARCH = "qwen2-vl-7b"
B, S, GRID = 2, 16, 2  # a GRID x GRID visual span in the first slots


def smoke_pair(**over):
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), **over),
            dataclasses.replace(tconfigs.smoke_config(ARCH), **over))


def vlm_positions(b: int, s: int, grid: int) -> np.ndarray:
    """``[b, s, 3]`` (t, h, w): the visual span a grid x grid patch grid at
    t = 0 (h = row, w = col), the text after it from max + 1 with t == h == w."""
    n_vis = grid * grid
    pos = np.zeros((s, 3), np.int32)
    rows, cols = np.divmod(np.arange(n_vis), grid)
    pos[:n_vis, 1], pos[:n_vis, 2] = rows, cols
    pos[n_vis:] = (grid + np.arange(s - n_vis))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def test_mrope_angles_are_the_references_bit_for_bit():
    cfg = tconfigs.smoke_config(ARCH)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)  # t, h and w all distinct
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    for head_dim, sections, theta in ((cfg.head_dim, cfg.m_rope_sections, cfg.rope_theta),
                                      (128, (16, 24, 24), 1e6)):  # qwen2-vl-7b's own
        want = jlayers.mrope_angles(jnp.asarray(pos), head_dim, theta, sections)
        got = tlayers.mrope_angles(torch.from_numpy(pos), head_dim, theta, sections)
        assert got.dtype == torch.float32 and got.shape == (2, 7, head_dim // 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # text tokens (t == h == w) reduce to plain RoPE
    text = np.broadcast_to(pos[..., :1], pos.shape).copy()
    np.testing.assert_array_equal(
        tlayers.mrope_angles(torch.from_numpy(text), 128, 1e6, (16, 24, 24)).numpy(),
        tlayers.rope_angles(torch.from_numpy(pos[..., 0]), 128, 1e6).numpy())
    with pytest.raises(AssertionError):
        jlayers.mrope_angles(jnp.asarray(pos), 16, 1e6, (2, 3, 4))
    with pytest.raises(ValueError, match="sum to head_dim // 2"):
        tlayers.mrope_angles(torch.from_numpy(pos), 16, 1e6, (2, 3, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_with_visual_embeds_matches_jax(impl, dtype):
    jcfg, tcfg = smoke_pair(dtype=dtype)
    assert jcfg.qkv_bias and jcfg.m_rope
    jparams, tparams = shared_params(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    vis = (0.5 * rng.standard_normal((B, GRID * GRID, jcfg.d_model))).astype(np.float32)
    pos = vlm_positions(B, S, GRID)
    want, _ = jbuild(jcfg).forward(jparams, jnp.asarray(toks), positions=jnp.asarray(pos),
                                   visual_embeds=jnp.asarray(vis),
                                   impl="flash_interpret" if impl == "flash" else "xla")
    got, aux = tbuild(tcfg).forward(tparams, torch.from_numpy(toks),
                                    positions=torch.from_numpy(pos),
                                    visual_embeds=torch.from_numpy(vis), impl=impl)
    assert got.shape == want.shape and str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
    assert float(aux) == 0.0
    # the visual slots change the logits; the default positions are text's (t == h == w)
    plain, _ = tbuild(tcfg).forward(tparams, torch.from_numpy(toks), impl=impl)
    jplain, _ = jbuild(jcfg).forward(jparams, jnp.asarray(toks), impl="xla")
    np.testing.assert_allclose(as_np(plain), as_np(jplain), **TOL[dtype])
    assert not np.allclose(as_np(plain), as_np(got), **TOL[dtype])


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "per_slot_pos"])
def test_decode_equals_forward(per_slot):
    """Teacher-forced decode steps (text positions t == h == w from the
    cache position; a ``[B]`` position tensor as the batcher passes it)
    give the forward's logits, and the reference's."""
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    api, japi = tbuild(tcfg), jbuild(jcfg)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, 12)).astype(np.int32)
    full, _ = api.forward(tparams, torch.from_numpy(toks))
    caches = api.init_caches(B, 12, torch.float32, device="cpu")
    jcaches = japi.init_caches(B, 12, jnp.float32)
    jdecode = jax.jit(japi.decode)  # one trace for the 12 steps
    for t in range(12):
        pos = torch.full((B,), t, dtype=torch.int32) if per_slot else t
        got, caches = api.decode(tparams, torch.from_numpy(toks[:, t:t + 1]), pos, caches)
        want, jcaches = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(pos) if per_slot else jnp.int32(t), jcaches)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])


def test_greedy_tokens_equal_jax():
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jengine.greedy_generate(jbuild(jcfg), jparams, jnp.asarray(prompt), steps=6,
                                   cache_len=13)
    got = tengine.greedy_generate(tbuild(tcfg), tparams, torch.from_numpy(prompt), steps=6,
                                  cache_len=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
