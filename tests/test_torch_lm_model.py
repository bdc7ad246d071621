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
from repro_torch.models.lm.api import build as tbuild
from repro_torch.tree import tree_leaves_with_path

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}

# the dense family's smoke configs: plain GQA, QKV bias, qk-norm, and
# qk-norm with bfloat16 parameters (qwen3-8b's own param_dtype)
CASES = {
    "llama3.2-3b": ("llama3.2-3b", {}),
    "qwen2-7b": ("qwen2-7b", {}),
    "qwen3-8b": ("qwen3-8b", {}),
    "qwen3-8b-bf16-params": ("qwen3-8b", {"param_dtype": "bfloat16"}),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case, impl, dtype):
    arch, over = CASES[case]
    jcfg, tcfg = smoke_pair(arch, dtype=dtype, **over)
    jparams, tparams = shared_params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, jaux = jbuild(jcfg).forward(jparams, jnp.asarray(toks),
                                      impl="flash_interpret" if impl == "flash" else "xla")
    got, aux = tbuild(tcfg).forward(tparams, torch.from_numpy(toks), impl=impl)
    assert got.shape == want.shape == (2, 16, jtfm.vocab_padded(jcfg))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
    assert float(aux) == float(jaux) == 0.0


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
