"""The port's LM decoder against the JAX package's: the config registry,
parameter specs and init, and ``LMApi.forward`` logits on the dense
family's smoke configs, with impl "xla" and "flash" (JAX's flash path runs
the Pallas kernel in interpret mode, the port's the plain version of
kernel #7).

Weights come from the JAX ``init`` and cross over through
``convert.lm_params_from_numpy`` (dtypes kept); the leaves the init makes
constant (biases, norm scales) get noise first so that they are
exercised.  Tolerances: float32 compute 1e-5 (sum order), bfloat16
compute 3e-2 (``tests/test_kernels.py``'s bfloat16 tolerance: the two
frameworks round intermediate bfloat16 products at other places)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import layers as jlayers
from repro.models.lm import transformer as jtfm
from repro.models.lm.api import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm.api import build as tbuild
from repro_torch.tree import tree_leaves_with_path
from test_torch_lm_moe import run_recorded

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}

# the dense family's smoke configs: plain GQA, QKV bias, qk-norm, and
# qk-norm with bfloat16 parameters (qwen3-8b's own param_dtype); the MoE
# family's: 4 experts top-2, untied (dbrx) and tied with a soft cap (grok)
CASES = {
    "llama3.2-3b": ("llama3.2-3b", {}),
    "qwen2-7b": ("qwen2-7b", {}),
    "qwen3-8b": ("qwen3-8b", {}),
    "qwen3-8b-bf16-params": ("qwen3-8b", {"param_dtype": "bfloat16"}),
    "dbrx-132b": ("dbrx-132b", {}),
    "grok-1-314b": ("grok-1-314b", {}),
}


def smoke_pair(arch: str, **over):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **over),
            dataclasses.replace(tconfigs.smoke_config(arch), **over))


def shared_params(jcfg, seed=0):
    """(JAX params, the port's params): the same weights."""
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def perturb(a):
        if a.size and (a == a.flat[0]).all():
            a = (a.astype(np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree.map(perturb, params)
    return jax.tree.map(jnp.asarray, params), lm_params_from_numpy(params, device="cpu")


def as_np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_config_registry_is_the_reference_s():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(
            jconfigs.get_config(arch))
        assert dataclasses.asdict(tconfigs.smoke_config(arch)) == dataclasses.asdict(
            jconfigs.smoke_config(arch))
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.grid() == jconfigs.grid()


@pytest.mark.parametrize("case", CASES)
def test_init_matches_decoder_specs(case):
    """The port's init gives the reference's tree: the same paths, shapes
    and dtypes as the JAX init (the stacked ``scan`` axis included)."""
    arch, over = CASES[case]
    jcfg, tcfg = smoke_pair(arch, **over)
    jp = jax.tree_util.tree_flatten_with_path(jbuild(jcfg).init(jax.random.key(0)))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in jp}
    tp = tbuild(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = {k.replace("/", ""): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_leaves_with_path(tp)}
    assert got == want


def test_p_init_statistics():
    specs = {"w": tlayers.P((512, 256), (None, None)), "s": tlayers.P((64, 32), (None, None), scale=0.02),
             "z": tlayers.P((7,), (None,), init="zeros"), "o": tlayers.P((3, 5), (None, None), init="ones"),
             "v": tlayers.P((4096,), (None,))}
    p = tlayers.init_from_specs(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    assert float(p["w"].float().std()) == pytest.approx(512 ** -0.5, rel=0.02)  # fan-in
    assert float(p["s"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert float(p["v"].float().std()) == pytest.approx(4096 ** -0.5, rel=0.05)  # 1-D: its length
    assert abs(float(p["w"].float().mean())) < 3 * 512 ** -0.5 / 362
    assert (p["z"] == 0).all() and (p["o"] == 1).all()
    with pytest.raises(ValueError):
        tlayers.P((2, 3), (None,))


def test_p_init_draws_a_large_leaf_by_slices(monkeypatch):
    """A leaf above DRAW_ELEMENTS is drawn one leading slice at a time (its
    float32 draw never exists whole), with the leaf's fan-in scale."""
    monkeypatch.setattr(tlayers, "DRAW_ELEMENTS", 1000)
    specs = {"w": tlayers.P((3, 4, 256, 64), (None, None, None, None))}
    w = tlayers.init_from_specs(specs, torch.Generator().manual_seed(0), torch.bfloat16)["w"]
    assert w.shape == (3, 4, 256, 64) and w.dtype == torch.bfloat16
    assert float(w.float().std()) == pytest.approx(256 ** -0.5, rel=0.02)
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0], w[1])
    gen = torch.Generator().manual_seed(0)  # slices drawn in order, each as a leaf of its own
    first = (torch.randn((256, 64), generator=gen) * 256 ** -0.5).bfloat16()
    assert torch.equal(w[0, 0], first)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(monkeypatch, case, impl, dtype):
    """MoE configs: both packages' routes of every (layer, token) are the
    same experts, or a near-tie in both (``moe.route_flips``: two
    frameworks' bf16 roundings can move one); logits are held on the
    tokens whose routes agree in every layer, the aux loss at 1e-6 in
    float32."""
    arch, over = CASES[case]
    jcfg, tcfg = smoke_pair(arch, dtype=dtype, **over)
    jparams, tparams = shared_params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    (want, jaux), rec = run_recorded(
        monkeypatch, functools.partial(jbuild(jcfg).forward,
                                       impl="flash_interpret" if impl == "flash" else "xla"),
        jparams, jnp.asarray(toks))
    routes = []
    got, aux = tbuild(tcfg).forward(tparams, torch.from_numpy(toks), impl=impl, routes=routes)
    assert got.shape == want.shape == (2, 16, jtfm.vocab_padded(jcfg))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if not jcfg.is_moe:
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
        assert float(aux) == float(jaux) == 0.0 and not routes
        return
    jids, jgap = rec.routes(jcfg.experts_per_tok)
    assert len(routes) == len(jids) == jcfg.num_layers
    flipped, unexplained = tmoe.route_flips(
        torch.stack([r.expert_ids for r in routes]), torch.stack([r.gap for r in routes]),
        jids, jgap, getattr(torch, dtype))
    assert not unexplained.any(), unexplained.nonzero().tolist()
    agree = ~flipped.any(0).numpy()
    np.testing.assert_allclose(as_np(got)[agree], as_np(want)[agree], **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux),
                               **(dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else TOL[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    ja = jlayers.rope_angles(jnp.asarray(pos), 16, 5e5)
    ta = tlayers.rope_angles(torch.from_numpy(pos), 16, 5e5)
    np.testing.assert_allclose(as_np(ta), as_np(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(as_np(tlayers.apply_rope(tx, ta)),
                               as_np(jlayers.apply_rope(jx, ja)), **TOL[dtype])
    np.testing.assert_allclose(as_np(tlayers.rms_norm(tx, torch.from_numpy(scale), 1e-6)),
                               as_np(jlayers.rms_norm(jx, jnp.asarray(scale), 1e-6)), **TOL[dtype])
