"""The serving path of the port's encoder-decoder (whisper-large-v3's
backbone) against the JAX package's: ``precompute_cross`` +
``decode_step`` against the reference and against ``decode_train``,
``make_prefill`` with frames, greedy and batcher tokens, and the flash
path's precondition at whisper's real 1,500 frames (a property of the
reference: ``min(512, 1500)`` does not divide 1,500).

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``
(constant leaves get noise); inputs from numpy.  Tolerances: float32
compute 1e-5 (sum order); decode == decode_train 5e-4, as
``tests/test_decode_equivalence.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import encdec as jencdec
from repro.models.lm.api import build as jbuild
from repro.serve import batcher as jbatcher
from repro.serve import engine as jengine
from repro_torch.models.lm import encdec as tencdec
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as tengine
from test_torch_lm_encdec import B, S, frames_of, jencode, shared_params, smoke_pair
from test_torch_lm_model import TOL, as_np


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "per_slot_pos"])
def test_precompute_cross_and_decode_step_match_jax_and_decode_train(per_slot):
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    frames = frames_of(jcfg, B)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jenc = jencode(jparams, jcfg, jnp.asarray(frames))
    tenc = tencdec.encode(tparams, tcfg, torch.from_numpy(frames))
    jcross = jencdec.precompute_cross(jparams, jcfg, jenc)
    tcross = tencdec.precompute_cross(tparams, tcfg, tenc)
    for got, want in zip(tcross, jcross):
        assert got.shape == want.shape == (jcfg.num_layers, B, jcfg.encoder_seq,
                                           jcfg.num_kv_heads, jcfg.head_dim)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])
    full = tencdec.decode_train(tparams, tcfg, torch.from_numpy(toks), tenc)
    tc = tencdec.init_encdec_caches(tcfg, B, S, torch.float32, device="cpu")
    jc = jencdec.init_encdec_caches(jcfg, B, S, jnp.float32)
    jstep = jax.jit(jencdec.decode_step, static_argnums=1)
    for t in range(S):
        pos = np.full((B,), t, np.int32) if per_slot else t
        got, tc = tencdec.decode_step(tparams, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.from_numpy(pos) if per_slot else t, tc, tcross)
        want, jc = jstep(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos), jc,
                         jcross)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(), rtol=5e-4, atol=5e-4)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(as_np(getattr(tc, name)), as_np(getattr(jc, name)),
                                   **TOL["float32"])


def test_serving_prefill_matches_jax():
    """``make_prefill`` encodes the frames and precomputes the cross K/V;
    the decode steps after it read them from the state."""
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    frames = frames_of(jcfg, B, seed=4)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    js = jengine.init_serve_state(japi, B, S + 2, dtype=jnp.float32)
    ts = tengine.init_serve_state(tapi, B, S + 2, dtype=torch.float32, device="cpu")
    assert all(t.shape == j.shape and not t.any() for t, j in zip(ts.cross_kv, js.cross_kv))
    jl, js = jengine.make_prefill(japi)(jparams, js, jnp.asarray(prompt), jnp.asarray(frames))
    tl, ts = tengine.make_prefill(tapi)(tparams, ts, torch.from_numpy(prompt),
                                        torch.from_numpy(frames))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL["float32"])
    for got, want in zip(ts.cross_kv, js.cross_kv):
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])
    tok = np.argmax(as_np(tl)[:, :jcfg.vocab_size], -1).astype(np.int32)[:, None]
    jl, js = jengine.make_serve_step(japi)(jparams, js, jnp.asarray(tok))
    tl, ts = tengine.make_serve_step(tapi)(tparams, ts, torch.from_numpy(tok))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL["float32"])
    assert ts.cache_pos == int(js.cache_pos) == S + 1


def test_greedy_tokens_equal_jax():
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jengine.greedy_generate(jbuild(jcfg), jparams, jnp.asarray(prompt), steps=6,
                                   cache_len=13)
    got = tengine.greedy_generate(tbuild(tcfg), tparams, torch.from_numpy(prompt), steps=6,
                                  cache_len=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")  # greedy's float32 caches: refused
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        tengine.greedy_generate(tbuild(bf16), tparams, torch.from_numpy(prompt), steps=2,
                                cache_len=9)


def _reset_slot_of_a_stacked_cache(self, s: int) -> None:
    """The reference batcher's slot reset for a cache tree that is one
    ``AttnCache`` stacked ``[L, B, ...]`` (the encoder-decoder's): its own
    ``_reset_slot`` takes only the decoder's dict of caches and raises
    TypeError here.  The semantics are its own: pos -1, K/V zeros."""
    c = self.state.caches
    self.state = jengine.ServeState(
        caches=jax.tree_util.tree_map(
            lambda x: x.at[:, s].set(-1 if jnp.issubdtype(x.dtype, jnp.integer) else 0), c),
        cache_pos=self.state.cache_pos, cross_kv=self.state.cross_kv)


def test_batcher_tokens_equal_jax(monkeypatch):
    """4 requests through 2 slots (slots reused mid-stream), decoding
    against the zero placeholder cross K/V the reference's batcher
    carries."""
    jcfg, tcfg = smoke_pair()
    jparams, tparams = shared_params(jcfg)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, jcfg.vocab_size, n).tolist(), m) for n, m in ((3, 4), (5, 2),
                                                                          (2, 3), (4, 2))]
    jb = jbatcher.ContinuousBatcher(jbuild(jcfg), 2, 12, jparams)
    with pytest.raises(TypeError):  # the reference's own reset
        jb.submit(jbatcher.Request(0, [1], 1))
        jb.step()
    monkeypatch.setattr(jbatcher.ContinuousBatcher, "_reset_slot", _reset_slot_of_a_stacked_cache)
    jb = jbatcher.ContinuousBatcher(jbuild(jcfg), 2, 12, jparams)
    tb = ContinuousBatcher(tbuild(tcfg), 2, 12, tparams, device="cpu")
    for i, (prompt, m) in enumerate(reqs):
        jb.submit(jbatcher.Request(i, prompt, m))
        tb.submit(Request(i, prompt, m))
    want = {r.rid: r.out for r in jb.run()}
    got = {r.rid: r.out for r in tb.run()}
    assert got == want and len(got) == len(reqs)


def test_flash_on_whisper_frames_raises_in_both_packages():
    """At 1,500 frames the flash path's blocks are min(512, 1500) = 512,
    which do not divide 1,500: the reference's kernel asserts, the port's
    wrapper raises the same precondition.  Reduced width, the real frame
    count; 1,024 frames pass."""
    over = dict(encoder_layers=1, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                encoder_seq=1500)
    jcfg, tcfg = smoke_pair(**over)
    jparams, tparams = shared_params(jcfg)
    frames = frames_of(jcfg, 1)
    with pytest.raises(AssertionError):
        jencdec.encode(jparams, jcfg, jnp.asarray(frames), impl="flash_interpret")
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tencdec.encode(tparams, tcfg, torch.from_numpy(frames), impl="flash")
    short = torch.from_numpy(frames[:, :1024])
    np.testing.assert_allclose(
        tencdec.encode(tparams, tcfg, short, impl="flash").numpy(),
        tencdec.encode(tparams, tcfg, short, impl="xla").numpy(), **TOL["float32"])
