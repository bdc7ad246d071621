"""The port's LM decode path and plain attention against the JAX package's:
``decode_step`` over 12 tokens with float32 and bfloat16 caches,
``attention_decode``'s ring buffer (``window``) and clamped slot,
``_sdpa_flash_xla`` (the S >= 8192 branch of impl "xla") at small chunks,
the MLP activations, and the port's own decode == forward property.

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``.
Tolerances: float32 1e-5 (sum order); bfloat16 3e-2 (a bfloat16 cache
rounds each k/v entry once, and a float32 difference of one ulp can round
to neighbouring bfloat16 values); decode == forward 5e-4, as
``tests/test_decode_equivalence.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import attention as jattn
from repro.models.lm import mlp as jmlp
from repro.models.lm import transformer as jtfm
from repro.models.lm.api import build as jbuild
from repro.models.lm.layers import init_from_specs as jinit
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import mlp as tmlp
from repro_torch.models.lm import transformer as ttfm
from repro_torch.models.lm.api import build as tbuild

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def smoke_pair(arch: str, **over):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **over),
            dataclasses.replace(tconfigs.smoke_config(arch), **over))


def shared(tree_jax):
    """A JAX params tree as (JAX arrays, the port's tensors): the same values."""
    params = jax.tree.map(np.asarray, tree_jax)
    rng = np.random.default_rng(0)

    def perturb(a):  # constant leaves (biases, norm scales) get noise
        if a.size and (a == a.flat[0]).all():
            a = (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree.map(perturb, params)
    return jax.tree.map(jnp.asarray, params), lm_params_from_numpy(params, device="cpu")


def as_np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-8b", "dbrx-132b", "grok-1-314b"])
def test_decode_step_matches_jax(arch, cache_dtype):
    jcfg, tcfg = smoke_pair(arch)
    jparams, tparams = shared(jbuild(jcfg).init(jax.random.key(0)))
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jtfm.init_caches(jcfg, B, S, getattr(jnp, cache_dtype))
    tc = ttfm.init_caches(tcfg, B, S, getattr(torch, cache_dtype), device="cpu")
    jstep = jax.jit(jtfm.decode_step, static_argnums=1)  # one trace for the 12 steps
    for t in range(S):
        want, jc = jstep(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jc)
        got, tc = ttfm.decode_step(tparams, tcfg, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[cache_dtype])
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(as_np(getattr(tc["scan"]["pos0"], name)),
                                   as_np(getattr(jc["scan"]["pos0"], name)), **TOL[cache_dtype])


@pytest.mark.parametrize("window,cache_len,steps", [(4, 8, 11), (None, 5, 8)])
def test_attention_decode_ring_buffer_and_clamped_slot_match_jax(window, cache_len, steps):
    """``window``: slots wrap around a ring of min(cache_len, window)
    entries; no window: positions past the cache's end overwrite its last
    slot (the reference's clamp)."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", window=window)
    jp, tp = shared(jinit(jattn.attention_specs(jcfg), jax.random.key(3)))
    B, D, hd = 2, jcfg.d_model, jcfg.head_dim
    x = np.random.default_rng(4).standard_normal((steps, B, 1, D)).astype(np.float32)
    jc = jattn.init_attn_cache(jcfg, B, cache_len, jnp.float32)
    tc = tattn.init_attn_cache(tcfg, B, cache_len, torch.float32, "cpu")
    assert tuple(tc.k.shape) == jc.k.shape
    jdecode = jax.jit(jattn.attention_decode, static_argnames=("cfg", "window"))
    for t in range(steps):
        pos = np.full((B, 1), t, np.int32)
        ja = jtfm.rope_angles(jnp.asarray(pos), hd, jcfg.rope_theta)
        ta = ttfm.rope_angles(torch.from_numpy(pos), hd, tcfg.rope_theta)
        want, jc = jdecode(jp, jnp.asarray(x[t]), cfg=jcfg, cache=jc, cache_pos=jnp.int32(t),
                           angles=ja, window=window)
        got, tc = tattn.attention_decode(tp, torch.from_numpy(x[t]), tcfg, tc, t,
                                         angles=ta, window=window)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,soft_cap", [(True, None, None), (True, 6, None),
                                                     (False, None, 30.0)])
def test_sdpa_flash_xla_matches_jax(dtype, causal, window, soft_cap):
    """The chunked online softmax of impl "xla" at S >= 8192, run at S = 16
    with 4-row query chunks and 8-key chunks."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", logits_soft_cap=soft_cap)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 16, h, 16)).astype(np.float32) for h in (4, 2, 2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn._sdpa_flash_xla(*(jnp.asarray(a, jd) for a in (q, k, v)), jcfg, causal=causal,
                                 window=window, q_chunk=4, k_chunk=8)
    got = tattn._sdpa_flash_xla(*(torch.from_numpy(a).to(td) for a in (q, k, v)), tcfg,
                                causal=causal, window=window, q_chunk=4, k_chunk=8)
    assert got.dtype == td
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
def test_mlp_matches_jax(act, gated):
    """``gelu`` is jax.nn.gelu's tanh approximation in both packages."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", act=act, mlp_gated=gated)
    jp, tp = shared(jinit(jmlp.mlp_specs(jcfg), jax.random.key(6)))
    x = np.random.default_rng(7).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(as_np(tmlp.mlp_forward(tp, torch.from_numpy(x), tcfg)),
                               as_np(jmlp.mlp_forward(jp, jnp.asarray(x), jcfg)), **TOL["float32"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-7b", "minitron-4b"])
def test_port_decode_matches_its_forward(arch):
    """tests/test_decode_equivalence.py's property on the port: stepping one
    token at a time through the caches reproduces the forward's logits."""
    cfg = tconfigs.smoke_config(arch)
    api = tbuild(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    for impl in ("xla", "flash"):
        ref, _ = api.forward(params, toks, impl=impl)
        caches = api.init_caches(B, S, torch.float32, device="cpu")
        outs = []
        for t in range(S):
            lg, caches = api.decode(params, toks[:, t:t + 1], t, caches)
            outs.append(lg)
        torch.testing.assert_close(torch.cat(outs, dim=1), ref, rtol=5e-4, atol=5e-4)


def test_decode_refuses_caches_wider_than_the_compute_dtype():
    """bfloat16 compute against float32 caches is outside the reference's
    domain (its scan carry would turn float32): both packages refuse it."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="bfloat16")
    jparams, tparams = shared(jbuild(jcfg).init(jax.random.key(0)))
    jc = jtfm.init_caches(jcfg, 1, 4, jnp.float32)
    with pytest.raises(TypeError, match="carry"):
        jtfm.decode_step(jparams, jcfg, jnp.zeros((1, 1), jnp.int32), jnp.int32(0), jc)
    tc = ttfm.init_caches(tcfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="outside the reference's domain"):
        ttfm.decode_step(tparams, tcfg, torch.zeros((1, 1), dtype=torch.int32), 0, tc)
