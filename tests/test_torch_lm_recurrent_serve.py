"""The port's recurrent LM families on the serving side, against the JAX
package's: greedy tokens, the bfloat16 serving path (prefill and serve
steps with bfloat16 caches), the per-family dtype domain of the greedy
server and the continuous batcher (a property of the reference, pinned in
both packages), and the batcher's reused slots and ``_reset_slot`` on the
recurrent states.

Weights and tolerances as ``test_torch_lm_recurrent.py``'s.  Greedy tokens
are equal, or first differ where the port's top two logits lie within
``GREEDY_TIE`` (1e-4) of each other."""
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
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as tengine
from repro_torch.tree import tree_leaves
from test_torch_lm_recurrent import ARCHS, TOL, both, close, decoder_params, smoke_pair

GREEDY_TIE = 1e-4


def greedy_margins(api, params, prompt, steps, cache_len):
    """The port's greedy path step by step: (tokens [B, steps], the gap
    between the top two logits at each step [B, steps])."""
    state = tengine.init_serve_state(api, prompt.shape[0], cache_len, dtype=torch.float32,
                                     device="cpu")
    lg, state = tengine.make_prefill(api)(params, state, prompt)
    toks, gaps = [], []
    for _ in range(steps):
        top2 = lg[:, : api.cfg.vocab_size].topk(2).values
        gaps.append(top2[:, 0] - top2[:, 1])
        toks.append(lg[:, : api.cfg.vocab_size].argmax(-1).to(torch.int32))
        lg, state = tengine.make_serve_step(api)(params, state, toks[-1][:, None])
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def jax_greedy(api, params, prompt, steps, cache_len):
    """The reference's ``greedy_generate`` with its prefill and its step each
    jitted once (its own loop unrolls the steps into one program)."""
    state = jengine.init_serve_state(api, prompt.shape[0], cache_len, dtype=jnp.float32)
    logits, state = jax.jit(jengine.make_prefill(api))(params, state, jnp.asarray(prompt))
    step = jax.jit(jengine.make_serve_step(api))
    out = []
    tok = jnp.argmax(logits[:, : api.cfg.vocab_size], axis=-1).astype(jnp.int32)
    for _ in range(steps):
        out.append(tok)
        logits, state = step(params, state, tok[:, None])
        tok = jnp.argmax(logits[:, : api.cfg.vocab_size], axis=-1).astype(jnp.int32)
    return jnp.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(arch):
    jcfg, tcfg = smoke_pair(arch)
    jp, tp = both(decoder_params(arch))
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 5)).astype(np.int32)
    want = np.asarray(jax_greedy(jbuild(jcfg), jp, prompt, 6, 12))
    api = tbuild(tcfg)
    got = tengine.greedy_generate(api, tp, torch.from_numpy(prompt), steps=6, cache_len=12)
    assert got.dtype == torch.int32 and got.shape == want.shape
    toks, gaps = greedy_margins(api, tp, torch.from_numpy(prompt), 6, 12)
    assert torch.equal(toks, got)
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row].numpy() != want[row])[0]
        if diff.size:  # a near-tie of the port's run may order either way
            assert float(gaps[row, diff[0]]) < GREEDY_TIE, (row, diff[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_step_with_bf16_caches_match_jax(arch):
    """The bfloat16 serving path: bfloat16 compute and caches, prefill of an
    8-token prompt, then 4 teacher-forced steps (RecurrentGemma's ring of 8
    wraps)."""
    jcfg, tcfg = smoke_pair(arch, dtype="bfloat16")
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp, tp = both(decoder_params(arch))
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (4, 2, 1)).astype(np.int32)
    js = jengine.init_serve_state(japi, 2, 16, dtype=jnp.bfloat16)
    ts = tengine.init_serve_state(tapi, 2, 16, dtype=torch.bfloat16, device="cpu")
    jl, js = jax.jit(jengine.make_prefill(japi))(jp, js, jnp.asarray(prompt))
    tl, ts = tengine.make_prefill(tapi)(tp, ts, torch.from_numpy(prompt))
    jstep, tstep = jax.jit(jengine.make_serve_step(japi)), tengine.make_serve_step(tapi)
    for tok in [None, *nxt]:
        if tok is not None:
            jl, js = jstep(jp, js, jnp.asarray(tok))
            tl, ts = tstep(tp, ts, torch.from_numpy(tok))
        close(tl, jl, TOL["bfloat16"])
    assert ts.cache_pos == int(js.cache_pos) == 12


DOMAIN = {"mamba2-2.7b": True, "recurrentgemma-9b": False, "llama3.2-3b": False,
          "dbrx-132b": False, "qwen2-vl-7b": False, "whisper-large-v3": False}
# the reference's batcher fails on the encoder-decoder's cache tree before any
# step (its slot reset takes only the decoder's dict), not on its carry
JAX_REFUSAL = {("whisper-large-v3", "batcher"): "'AttnCache' object is not iterable"}


@pytest.mark.parametrize("entry", ["greedy", "batcher"])
@pytest.mark.parametrize("arch", DOMAIN)
def test_bf16_domain_is_per_family_in_both_packages(arch, entry):
    """The greedy server and the batcher build float32 caches.  At bfloat16
    compute, attention against them widens the hidden state, which the
    reference's scan over layers refuses (a TypeError on its carry): so
    RecurrentGemma (local attention), the dense, MoE and VLM decoders and
    the encoder-decoder fail in the reference and are refused by the port
    (a ValueError naming the cause), while mamba2 (no attention) runs in
    both, its float32 conv and SSD states never widening the hidden state."""
    jcfg, tcfg = smoke_pair(arch, dtype="bfloat16")
    if DOMAIN[arch]:
        params = decoder_params(arch)
    else:  # refused before any weight is read: zeros of the init's shapes
        shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
        params = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), shapes)
    jp, tp = both(params)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 4)).astype(np.int32)

    def run_jax():
        if entry == "greedy":
            return np.asarray(jengine.greedy_generate(jbuild(jcfg), jp, jnp.asarray(prompt), 3, 8))
        cb = jbatcher.ContinuousBatcher(jbuild(jcfg), num_slots=2, cache_len=8, params=jp)
        for i, p in enumerate(prompt):
            cb.submit(jbatcher.Request(rid=i, prompt=p.tolist(), max_new=3))
        return np.array([r.out for r in sorted(cb.run(), key=lambda r: r.rid)])

    def run_port():
        api = tbuild(tcfg)
        if entry == "greedy":
            return tengine.greedy_generate(api, tp, torch.from_numpy(prompt), 3, 8).numpy()
        cb = ContinuousBatcher(api, 2, 8, tp, device="cpu")
        for i, p in enumerate(prompt):
            cb.submit(Request(rid=i, prompt=p.tolist(), max_new=3))
        return np.array([r.out for r in sorted(cb.run(), key=lambda r: r.rid)])

    if DOMAIN[arch]:
        for out in (run_jax(), run_port()):
            assert out.shape == (2, 3) and ((out >= 0) & (out < jcfg.vocab_size)).all()
        return
    with pytest.raises(TypeError, match=JAX_REFUSAL.get((arch, entry), "carry")):
        run_jax()
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        run_port()


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_reused_slot_equals_its_own_greedy_run(arch):
    """5 prompts on 3 slots (two requests admitted into a used slot, whose
    conv and recurrent states the previous occupant left): every request's
    tokens are the reference batcher's and its own ``greedy_generate``
    run's."""
    cfg = tconfigs.smoke_config(arch)
    params = decoder_params(arch)
    jp, tp = both(params)
    rng = np.random.default_rng(6)
    jobs = [(rng.integers(0, cfg.vocab_size, 4 + i % 3).tolist(), 3 + i % 2) for i in range(5)]
    jcb = jbatcher.ContinuousBatcher(jbuild(jconfigs.smoke_config(arch)), num_slots=3,
                                     cache_len=16, params=jp)
    cb = ContinuousBatcher(tbuild(cfg), 3, 16, tp, device="cpu")
    for i, (p, m) in enumerate(jobs):
        jcb.submit(jbatcher.Request(rid=i, prompt=p, max_new=m))
        cb.submit(Request(rid=i, prompt=p, max_new=m))
    got = {r.rid: r.out for r in cb.run()}
    assert len(got) == len(jobs) > cb.num_slots
    assert got == {r.rid: r.out for r in jcb.run()}
    api = tbuild(cfg)
    for i, (p, m) in enumerate(jobs):
        seq = tengine.greedy_generate(api, tp, torch.tensor([p], dtype=torch.int32), steps=m,
                                      cache_len=16)
        assert got[i] == seq[0].tolist(), i


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slot_zeroes_the_recurrent_states_as_jax(arch):
    """After 3 steps on 2 slots, slot 1 reset in both packages: every cache
    leaf agrees, slot 1's states and K/V are zero (its positions -1), slot
    0's untouched."""
    cfg = tconfigs.smoke_config(arch)
    jp, tp = both(decoder_params(arch))
    jcb = jbatcher.ContinuousBatcher(jbuild(jconfigs.smoke_config(arch)), num_slots=2,
                                     cache_len=12, params=jp)
    tcb = ContinuousBatcher(tbuild(cfg), 2, 12, tp, device="cpu")
    for i, p in enumerate([[1, 2, 3, 4], [5, 6, 7]]):
        jcb.submit(jbatcher.Request(rid=i, prompt=p, max_new=4))
        tcb.submit(Request(rid=i, prompt=p, max_new=4))
    for _ in range(3):
        jcb.step()
        tcb.step()
    jcb._reset_slot(1)
    tcb._reset_slot(1)
    for key, dim in (("scan", 1), ("tail", 0)):
        jl = jax.tree.leaves(jcb.state.caches.get(key))
        tl = tree_leaves(tcb.state.caches.get(key))
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
            assert (t.select(dim, 1) == (0 if t.dtype.is_floating_point else -1)).all()
            if t.dtype.is_floating_point:
                assert t.select(dim, 0).abs().sum() > 0
