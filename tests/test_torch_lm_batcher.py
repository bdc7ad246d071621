"""The port's continuous batcher against the JAX package's
(``repro/serve/batcher.py``): the reference's two batcher tests
(``tests/test_serving_extras.py``) run through both packages on llama's
dense and dbrx's MoE smoke configs — slots reused, requests admitted
mid-stream at their own cache positions — with the port's tokens equal to
the reference's and to the port's own one-at-a-time ``greedy_generate``;
``_reset_slot`` against the reference's; the bf16-compute config refused
in both packages; and the batcher's default device.

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``
(float32, the smoke configs' dtype); prompts from numpy.  Greedy tokens
are compared exactly."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm.api import build as jbuild
from repro.serve import batcher as jbatcher
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as tengine
from repro_torch.tree import tree_leaves

ARCHS = ["llama3.2-3b", "dbrx-132b"]


def jobs_sequential(vocab):
    """test_continuous_batcher_matches_sequential: 5 prompts of 5 tokens, 4
    new each, on 3 slots (at least one slot reused), cache_len 32."""
    rng = np.random.default_rng(0)
    return 0, 3, 32, [(rng.integers(0, vocab, 5).tolist(), 4) for _ in range(5)]


def jobs_midstream(vocab):
    """test_continuous_batcher_midstream_admission_tight_cache: 6 requests of
    4-7 prompt tokens and 3-5 new on 2 slots, cache_len 16: each fits the
    cache, the run's steps do not."""
    rng = np.random.default_rng(1)
    return 1, 2, 16, [(rng.integers(0, vocab, 4 + i % 4).tolist(), 3 + i % 3) for i in range(6)]


SCENARIOS = {"sequential": jobs_sequential, "midstream": jobs_midstream}


@functools.cache
def params_np(arch: str, seed: int) -> dict:
    cfg = jconfigs.smoke_config(arch)
    return jax.tree.map(np.asarray, jax.jit(jbuild(cfg).init)(jax.random.key(seed)))


def run_jax(arch, seed, slots, cache_len, jobs, **over):
    cfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
    cb = jbatcher.ContinuousBatcher(jbuild(cfg), num_slots=slots, cache_len=cache_len,
                                    params=jax.tree.map(jnp.asarray, params_np(arch, seed)))
    for i, (p, n) in enumerate(jobs):
        cb.submit(jbatcher.Request(rid=i, prompt=p, max_new=n))
    return cb


def port_batcher(arch, seed, slots, cache_len, **over):
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    return ContinuousBatcher(tbuild(cfg), slots, cache_len,
                             lm_params_from_numpy(params_np(arch, seed), device="cpu"),
                             device="cpu")


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_jax_and_sequential(arch, scenario):
    seed, slots, cache_len, jobs = SCENARIOS[scenario](tconfigs.smoke_config(arch).vocab_size)
    want = {r.rid: r.out for r in run_jax(arch, seed, slots, cache_len, jobs).run()}
    cb = port_batcher(arch, seed, slots, cache_len)
    for i, (p, n) in enumerate(jobs):
        cb.submit(Request(rid=i, prompt=p, max_new=n))
    steps = 0
    while cb.queue or any(r is not None for r in cb.slot_req):
        assert cb.step() <= slots
        steps += 1
    assert len(cb.finished) == len(jobs) == len(want)
    got = {r.rid: r.out for r in cb.finished}
    assert got == want
    if scenario == "midstream":
        assert steps > cache_len  # the regime a shared position counter could not serve
    # the reference test's claim on the port: each request's tokens are its
    # own greedy_generate run's
    api = tbuild(tconfigs.smoke_config(arch))
    tp = lm_params_from_numpy(params_np(arch, seed), device="cpu")
    for i, (p, n) in enumerate(jobs):
        seq = tengine.greedy_generate(api, tp, torch.tensor([p], dtype=torch.int32), steps=n,
                                      cache_len=cache_len)
        assert got[i] == seq[0].tolist(), i


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_batcher_matches_its_greedy_generate(arch):
    """The reference test's claim on the reference, for the MoE config too
    (its own test runs llama's): the batcher's tokens are greedy_generate's."""
    seed, slots, cache_len, jobs = jobs_sequential(jconfigs.smoke_config(arch).vocab_size)
    got = {r.rid: r.out for r in run_jax(arch, seed, slots, cache_len, jobs).run()}
    api = jbuild(jconfigs.smoke_config(arch))
    greedy = jax.jit(jengine.greedy_generate, static_argnums=(0, 3, 4))
    prompts = jnp.asarray([p for p, _ in jobs], jnp.int32)  # one compile: equal lengths
    want = np.asarray(greedy(api, jax.tree.map(jnp.asarray, params_np(arch, seed)), prompts, 4,
                             cache_len))
    assert [got[i] for i in range(len(jobs))] == want.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slot_matches_jax(arch):
    """Two slots (== the smoke configs' two stacked layers, so the slot dim
    can only be found by structure): after 5 steps, slot 1 is reset in
    both packages; every cache leaf agrees, slot 1's K/V are zero and its
    positions -1, slot 0's untouched."""
    seed, _, _, jobs = jobs_midstream(tconfigs.smoke_config(arch).vocab_size)
    jcb = run_jax(arch, seed, 2, 16, jobs[:2])
    tcb = port_batcher(arch, seed, 2, 16)
    for i, (p, n) in enumerate(jobs[:2]):
        tcb.submit(Request(rid=i, prompt=p, max_new=n))
    for _ in range(5):
        jcb.step()
        tcb.step()
    before = [t.clone() for t in tree_leaves(tcb.state.caches)]
    jcb._reset_slot(1)
    tcb._reset_slot(1)
    jleaves = jax.tree.leaves(jcb.state.caches)
    tleaves = tree_leaves(tcb.state.caches)
    assert len(jleaves) == len(tleaves) == 3
    for j, t, b in zip(jleaves, tleaves, before):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        assert (t[:, 1] == (0 if t.dtype.is_floating_point else -1)).all()
        assert torch.equal(t[:, 0], b[:, 0]) and not torch.equal(t[:, 1], b[:, 1])


def test_bf16_compute_config_fails_in_both_packages():
    """The reference's batcher builds float32 caches; at bfloat16 compute its
    jitted step refuses the float32 hidden state on its scan carry.  The
    port refuses the same config when the batcher is made, naming the
    cause."""
    seed, slots, cache_len, jobs = jobs_sequential(257)
    jcb = run_jax("llama3.2-3b", seed, slots, cache_len, jobs, dtype="bfloat16")
    with pytest.raises(TypeError, match="carry"):
        jcb.run()
    with pytest.raises(ValueError, match="outside the reference's domain"):
        port_batcher("llama3.2-3b", seed, slots, cache_len, dtype="bfloat16")


def test_batcher_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.smoke_config("llama3.2-3b")
    api = tbuild(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(api, 2, 8, params)
