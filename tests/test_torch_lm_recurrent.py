"""The port's recurrent LM families against the JAX package's: mamba2's SSD
block (``models/lm/ssm.py``) and RecurrentGemma's RG-LRU block with local
attention (``models/lm/rglru.py``), module by module and through the
decoder (forward, decode, decode == forward across a ring wrap); the
parameter specs at full width; and the cache bytes at 4,096 and 524,288
positions (the reference's ``long_500k`` claim: O(1) state for mamba2, a
ring of ``window`` slots for RecurrentGemma).  The serving side is in
``test_torch_lm_recurrent_serve.py``.

Inputs are made with numpy from a seed; weights come from the JAX ``init``
through ``convert.lm_params_from_numpy``, their constant leaves (biases,
norm scales, ``a_log``, ``dt_bias``, ``d_skip``, ``lam``) perturbed so that
they are exercised.  Tolerances: float32 1e-5 (sum order; the RG-LRU scan
adds in another order than ``jax.lax.associative_scan``, and its float32
results measured within 2e-6 of the reference's at these sizes); bfloat16
compute 3e-2 (``tests/test_kernels.py``'s bfloat16 tolerance); decode ==
forward 5e-4, as ``tests/test_decode_equivalence.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import rglru as jrglru
from repro.models.lm import ssm as jssm
from repro.models.lm import transformer as jtfm
from repro.models.lm.api import build as jbuild
from repro.models.lm.layers import init_from_specs as jinit
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import rglru as trglru
from repro_torch.models.lm import ssm as tssm
from repro_torch.models.lm import transformer as ttfm
from repro_torch.models.lm.api import build as tbuild
from repro_torch.tree import tree_leaves

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]


def smoke_pair(arch: str, **over):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **over),
            dataclasses.replace(tconfigs.smoke_config(arch), **over))


def perturbed(tree, seed=0):
    """A JAX params tree as numpy, constant leaves given noise."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a)
        if a.size and (a == a.flat[0]).all():
            a = (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(perturb, tree)


def both(tree_np):
    """(JAX arrays, the port's tensors) of one numpy tree."""
    return jax.tree.map(jnp.asarray, tree_np), lm_params_from_numpy(tree_np, device="cpu")


@functools.cache
def decoder_params(arch: str) -> dict:
    cfg = jconfigs.smoke_config(arch)
    return perturbed(jax.jit(jbuild(cfg).init)(jax.random.key(0)))


def block_params(specs_fn, arch: str, seed: int):
    jcfg, tcfg = smoke_pair(arch)
    return jcfg, tcfg, both(perturbed(jinit(specs_fn(jcfg), jax.random.key(seed)), seed))


def as_np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol=TOL["float32"]):
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_state", "state", "bf16_input_float32_state"])
def test_causal_conv_matches_jax(case):
    """With a carried state the new state is the trailing W-1 inputs; a
    bfloat16 input against a float32 state computes and returns float32
    (the reference's concatenation promotes), each tap rounded to bfloat16
    first."""
    x, w, b = randn(0, 2, 5, 12), randn(1, 4, 12), randn(2, 12)
    state = None if case == "no_state" else randn(3, 2, 3, 12)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case.startswith("bf16"):
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    js = None if state is None else jnp.asarray(state)
    ts = None if state is None else torch.from_numpy(state)
    want = jax.jit(jssm._causal_conv)(jx, jnp.asarray(w), jnp.asarray(b), js)
    got = tssm._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b), ts)
    for g, wnt in zip(got, want):
        close(g, wnt)


@pytest.mark.parametrize("init_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 8), (12, 4), (9, 9)])
def test_ssd_chunked_matches_jax(s, chunk, init_state):
    b, h, p, n = 2, 3, 4, 5
    xh, bm, cm = randn(0, b, s, h, p), randn(1, b, s, n), randn(2, b, s, n)
    dt = np.abs(randn(3, b, s, h, scale=0.5)) + 0.05
    a = -np.abs(randn(4, h)) - 0.1
    st = randn(5, b, h, p, n) if init_state else None
    want = jax.jit(jssm._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(t) for t in (xh, dt, a, bm, cm)), chunk, None if st is None else jnp.asarray(st))
    got = tssm._ssd_chunked(*(torch.from_numpy(t) for t in (xh, dt, a, bm, cm)), chunk,
                            None if st is None else torch.from_numpy(st))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("s,chunk", [(12, 8), (200, 128)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssm_forward_matches_jax(carried, s, chunk):
    """Chunks that do not divide S step down as the reference's do (12 with
    chunk 8 runs chunks of 6; 200 with mamba2-2.7b's 128 runs 100); with
    carried conv and SSD states (a continuation) and without."""
    jcfg, tcfg, (jp, tp) = block_params(jssm.ssm_specs, "mamba2-2.7b", 1)
    jcfg, tcfg = (dataclasses.replace(c, ssm_chunk=chunk) for c in (jcfg, tcfg))
    x = randn(6, 2, s, jcfg.d_model)
    conv = randn(7, 2, jcfg.ssm_conv_width - 1, jcfg.d_inner + 2 * jcfg.ssm_state)
    ssd = randn(8, 2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state, scale=0.3)
    jst = (jnp.asarray(conv), jnp.asarray(ssd)) if carried else (None, None)
    tst = (torch.from_numpy(conv), torch.from_numpy(ssd)) if carried else (None, None)
    want, (wc, ws) = jax.jit(jssm.ssm_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg, *jst)
    got, (gc, gs) = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg, *tst)
    for g, w in ((got, want), (gc, wc), (gs, ws)):
        close(g, w)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_jax(cache_dtype):
    """Six steps from a nonzero state; the SSD state stays float32, the conv
    state takes the promoted type of the cache's and the input's."""
    jcfg, tcfg, (jp, tp) = block_params(jssm.ssm_specs, "mamba2-2.7b", 2)
    conv = randn(1, 2, jcfg.ssm_conv_width - 1, jcfg.d_inner + 2 * jcfg.ssm_state)
    ssd = randn(2, 2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state, scale=0.3)
    jst = (jnp.asarray(conv, getattr(jnp, cache_dtype)), jnp.asarray(ssd))
    tst = (torch.from_numpy(conv).to(getattr(torch, cache_dtype)), torch.from_numpy(ssd))
    jdecode = jax.jit(jssm.ssm_decode, static_argnums=2)
    for t in range(6):
        x = randn(10 + t, 2, 1, jcfg.d_model)
        want, jst = jdecode(jp, jnp.asarray(x), jcfg, *jst)
        got, tst = tssm.ssm_decode(tp, torch.from_numpy(x), tcfg, *tst)
        close(got, want)
        for g, w in zip(tst, jst):
            close(g, w)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [13, 64])
def test_rglru_forward_matches_jax(s, carried):
    """The doubling scan against ``jax.lax.associative_scan``, at S = 13 (not
    a power of two) and 64, with a carried ``h_state`` folded into the
    first step (and a carried conv state) and without."""
    jcfg, tcfg, (jp, tp) = block_params(jrglru.rglru_specs, "recurrentgemma-9b", 3)
    rw = jcfg.rnn_width
    x = randn(4, 2, s, jcfg.d_model)
    conv, hs = randn(5, 2, jcfg.ssm_conv_width - 1, rw), randn(6, 2, rw)
    jst = (jnp.asarray(conv), jnp.asarray(hs)) if carried else (None, None)
    tst = (torch.from_numpy(conv), torch.from_numpy(hs)) if carried else (None, None)
    want, (wc, wh) = jax.jit(jrglru.rglru_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg,
                                                                     *jst)
    got, (gc, gh) = trglru.rglru_forward(tp, torch.from_numpy(x), tcfg, *tst)
    for g, w in ((got, want), (gc, wc), (gh, wh)):
        close(g, w)


def test_rglru_decode_matches_jax():
    jcfg, tcfg, (jp, tp) = block_params(jrglru.rglru_specs, "recurrentgemma-9b", 4)
    rw = jcfg.rnn_width
    jst = (jnp.asarray(randn(1, 2, jcfg.ssm_conv_width - 1, rw)), jnp.asarray(randn(2, 2, rw)))
    tst = tuple(torch.from_numpy(np.array(t)) for t in jst)
    jdecode = jax.jit(jrglru.rglru_decode, static_argnums=2)
    for t in range(5):
        x = randn(10 + t, 2, 1, jcfg.d_model)
        want, jst = jdecode(jp, jnp.asarray(x), jcfg, *jst)
        got, tst = trglru.rglru_decode(tp, torch.from_numpy(x), tcfg, *tst)
        close(got, want)
        for g, w in zip(tst, jst):
            close(g, w)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_linear_scan_is_the_sequential_recurrence(s):
    """The doubling scan equals h_t = a_t h_{t-1} + b_t stepped one position
    at a time, in float64 (so the two orders of addition agree to 1e-12)."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, s, 3)))
    b = torch.from_numpy(rng.standard_normal((2, s, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trglru.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

def spec_leaves(tree, path=""):
    """(JAX key path, spec) of a port spec tree (``P`` is a dataclass, which
    ``tree_leaves`` would descend into)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from spec_leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_specs_match_jax(arch):
    """The full configs build (no ``NotImplementedError``) and the decoder's
    specs are the reference's, leaf for leaf: shape, axes, initializer,
    scale; 64 ssm layers, or 12 superblocks of (rglru, rglru, local) and a
    tail of two rglru layers."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    tbuild(tcfg)
    want = jax.tree_util.tree_flatten_with_path(jtfm.decoder_specs(jcfg),
                                                is_leaf=lambda x: hasattr(x, "axes"))[0]
    got = dict(spec_leaves(ttfm.decoder_specs(tcfg)))
    assert got.keys() == {jax.tree_util.keystr(k) for k, _ in want}
    for k, p in want:
        assert dataclasses.astuple(got[jax.tree_util.keystr(k)]) == dataclasses.astuple(p)
    n = sum(int(np.prod(p.shape)) for p in got.values())
    assert n == pytest.approx({"mamba2-2.7b": 2.70e9, "recurrentgemma-9b": 9.42e9}[arch], rel=0.01)
    assert ttfm._layout(tcfg) == {"mamba2-2.7b": (64, 0), "recurrentgemma-9b": (12, 2)}[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl, dtype):
    """At S = 16 > window 8; impl "flash" runs #7's plain version in the
    port and the Pallas kernel in interpret mode in the reference."""
    jcfg, tcfg = smoke_pair(arch, dtype=dtype)
    jp, tp = both(decoder_params(arch))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jax.jit(functools.partial(jbuild(jcfg).forward,
                                        impl="flash_interpret" if impl == "flash" else "xla"))(
        jp, jnp.asarray(toks))
    got, aux = tbuild(tcfg).forward(tp, torch.from_numpy(toks), impl=impl)
    assert float(aux) == 0.0
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, cache_dtype):
    """12 steps at a cache_len of 12 (RecurrentGemma's local caches: a ring
    of window 8, wrapped); logits at every step, then every cache leaf and
    its dtype (a bfloat16 conv cache comes back float32 in both)."""
    jcfg, tcfg = smoke_pair(arch)
    jp, tp = both(decoder_params(arch))
    B, S = 2, 12
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jtfm.init_caches(jcfg, B, S, getattr(jnp, cache_dtype))
    tc = ttfm.init_caches(tcfg, B, S, getattr(torch, cache_dtype), device="cpu")
    jstep = jax.jit(jtfm.decode_step, static_argnums=1)
    for t in range(S):
        want, jc = jstep(jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jc)
        got, tc = ttfm.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        close(got, want, TOL[cache_dtype])
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        close(g, w, TOL[cache_dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_its_forward(arch):
    """tests/test_decode_equivalence.py's property on the port, at S = 12
    over RecurrentGemma's window of 8 (the ring wraps), impl "xla" and
    "flash"."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_are_o1_in_context(arch):
    """The caches at batch 1, bfloat16, at 4,096 and 524,288 positions (the
    reference's long_500k cell): the same bytes at both lengths, and the
    reference's shapes and dtypes (port on the meta device, the reference
    by ``jax.eval_shape``).  RecurrentGemma's local caches hold a ring of
    ``window`` (2,048) slots; a dense decoder's grow with the length."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    sizes = {}
    for n in (4096, 524288):
        tc = ttfm.init_caches(tcfg, 1, n, torch.bfloat16, device="meta")
        jc = jax.eval_shape(lambda n=n: jtfm.init_caches(jcfg, 1, n, jnp.bfloat16))
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tree_leaves(tc)] \
            == [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(jc)]
        sizes[n] = nbytes(tc)
        for c in ttfm._attn_caches(tc):
            assert c.k.shape[-3] == tcfg.window == 2048
    assert sizes[4096] == sizes[524288]
    dense = tconfigs.get_config("llama3.2-3b")
    assert (nbytes(ttfm.init_caches(dense, 1, 8192, torch.bfloat16, device="meta"))
            == 2 * nbytes(ttfm.init_caches(dense, 1, 4096, torch.bfloat16, device="meta")))
