"""The port's encoder-decoder (whisper-large-v3's backbone) against the JAX
package's: ``layer_norm`` and ``sinusoidal_positions``, the parameter
tree, and ``encode``, ``decode_train`` and ``forward`` on "xla" and
"flash" (the smoke config, ``encoder_seq`` 16; JAX's flash path runs the
Pallas kernel in interpret mode, the port's the plain version of kernel
#7).  Its serving path: tests/test_torch_lm_encdec_serve.py.

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``
(constant leaves, the norms' scales and biases among them, get noise);
inputs from numpy.  Tolerances: float32 compute 1e-5 (sum order),
bfloat16 compute 3e-2 (``tests/test_torch_lm_model.py``'s)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import encdec as jencdec
from repro.models.lm import layers as jlayers
from repro.models.lm.api import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models.lm import encdec as tencdec
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm.api import build as tbuild
from repro_torch.tree import tree_leaves_with_path
from test_torch_lm_model import TOL, as_np
from test_torch_lm_model import shared_params as _shared_params

ARCH = "whisper-large-v3"
B, S = 2, 8
shared_params = functools.lru_cache(_shared_params)  # one draw a config; no test writes params
jencode = jax.jit(jencdec.encode, static_argnums=1, static_argnames="impl")
jdecode_train = jax.jit(jencdec.decode_train, static_argnums=1, static_argnames="impl")


def smoke_pair(**over):
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), **over),
            dataclasses.replace(tconfigs.smoke_config(ARCH), **over))


def frames_of(cfg, b: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def jimpl(impl: str) -> str:
    return "flash_interpret" if impl == "flash" else "xla"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_sinusoidal_positions_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    got = tlayers.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    want = jlayers.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
    for n, d in ((16, 64), (1500, 1280), (7, 2)):
        pos = tlayers.sinusoidal_positions(n, d)
        assert pos.dtype == torch.float32
        np.testing.assert_array_equal(pos.numpy(), jlayers.sinusoidal_positions(n, d))


def test_init_matches_encdec_specs():
    jcfg, tcfg = smoke_pair()
    jp = jax.tree_util.tree_flatten_with_path(jbuild(jcfg).init(jax.random.key(0)))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in jp}
    tp = tbuild(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = {k.replace("/", ""): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_leaves_with_path(tp)}
    assert got == want
    assert got["['dec_pos']"][0][0] == 32768


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_decode_train_and_forward_match_jax(impl, dtype):
    jcfg, tcfg = smoke_pair(dtype=dtype)
    jparams, tparams = shared_params(jcfg)
    frames = frames_of(jcfg, B)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    cast = getattr(torch, dtype)
    jenc = jencode(jparams, jcfg, jnp.asarray(frames, getattr(jnp, dtype)), impl=jimpl(impl))
    tenc = tencdec.encode(tparams, tcfg, torch.from_numpy(frames).to(cast), impl=impl)
    assert tenc.shape == jenc.shape and tenc.dtype == cast
    np.testing.assert_allclose(as_np(tenc), as_np(jenc), **TOL[dtype])
    # the decoder on the same encoder states
    want = jdecode_train(jparams, jcfg, jnp.asarray(toks), jenc, impl=jimpl(impl))
    got = tencdec.decode_train(tparams, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(as_np(jenc)).to(cast), impl=impl)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
    # the whole pass, frames given and defaulted to zeros
    for fr in (frames, None):
        kw_j = {} if fr is None else {"frames": jnp.asarray(fr, getattr(jnp, dtype))}
        kw_t = {} if fr is None else {"frames": torch.from_numpy(fr).to(cast)}
        want, jaux = jax.jit(functools.partial(jbuild(jcfg).forward, impl=jimpl(impl)))(
            jparams, jnp.asarray(toks), **kw_j)
        got, aux = tbuild(tcfg).forward(tparams, torch.from_numpy(toks), impl=impl, **kw_t)
        assert got.shape == want.shape and str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])
        assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32
