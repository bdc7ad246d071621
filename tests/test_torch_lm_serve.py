"""The port's LM server against the JAX package's: greedy tokens, prefill
and decode with bfloat16 caches, the greedy server's dtype domain (a
property of the reference, pinned in both packages), the launcher's
output (the dense, MoE, recurrent, VLM and encoder-decoder families).

Weights come from the JAX ``init`` through ``convert.lm_params_from_numpy``;
prompts from numpy.  Tolerance of the bfloat16 path: 3e-2
(``tests/test_kernels.py``'s bfloat16 tolerance)."""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jlaunch
from repro.models.lm.api import build as jbuild
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models.lm.api import build as tbuild
from repro_torch.serve import engine as tengine

def pair(arch: str, **over):
    """(JAX api, JAX params, port api, port params): one smoke config, the
    same weights."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    params = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    return japi, jax.tree.map(jnp.asarray, params), tapi, lm_params_from_numpy(params, "cpu")


def test_greedy_tokens_equal_jax():
    japi, jp, tapi, tp = pair("llama3.2-3b")
    prompt = np.random.default_rng(0).integers(0, japi.cfg.vocab_size, (4, 8)).astype(np.int32)
    want = jengine.greedy_generate(japi, jp, jnp.asarray(prompt), steps=10, cache_len=19)
    got = tengine.greedy_generate(tapi, tp, torch.from_numpy(prompt), steps=10, cache_len=19)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_serve_step_with_bf16_caches_match_jax():
    """The bfloat16 serving path: a bfloat16-compute config, bfloat16
    caches, prefill of an 8-token prompt then 4 teacher-forced steps."""
    japi, jp, tapi, tp = pair("llama3.2-3b", dtype="bfloat16")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, japi.cfg.vocab_size, (2, 8)).astype(np.int32)
    nxt = rng.integers(0, japi.cfg.vocab_size, (4, 2, 1)).astype(np.int32)
    js = jengine.init_serve_state(japi, 2, 16, dtype=jnp.bfloat16)
    ts = tengine.init_serve_state(tapi, 2, 16, dtype=torch.bfloat16, device="cpu")
    jl, js = jengine.make_prefill(japi)(jp, js, jnp.asarray(prompt))
    tl, ts = tengine.make_prefill(tapi)(tp, ts, torch.from_numpy(prompt))
    assert ts.cache_pos == int(js.cache_pos) == 8
    jstep, tstep = jax.jit(jengine.make_serve_step(japi)), tengine.make_serve_step(tapi)
    for tok in [None, *nxt]:
        if tok is not None:
            jl, js = jstep(jp, js, jnp.asarray(tok))
            tl, ts = tstep(tp, ts, torch.from_numpy(tok))
        assert tl.dtype == torch.bfloat16 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   rtol=3e-2, atol=3e-2)
    assert ts.cache_pos == int(js.cache_pos) == 12


def test_greedy_generate_on_a_bf16_config_fails_in_both_packages():
    """The reference's greedy_generate builds float32 caches; at bfloat16
    compute its scan over layers refuses the float32 hidden state that
    attention against them returns.  The port refuses the same config
    before any work, naming the cause."""
    japi, jp, tapi, tp = pair("llama3.2-3b", dtype="bfloat16")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError, match="carry"):
        jengine.greedy_generate(japi, jp, jnp.asarray(prompt), steps=2, cache_len=7)
    with pytest.raises(ValueError, match=r"serve/engine\.py:100.*ROADMAP Queue 3"):
        tengine.greedy_generate(tapi, tp, torch.from_numpy(prompt), steps=2, cache_len=7)


def test_mark_cache_filled_matches_jax():
    japi, _, tapi, _ = pair("llama3.2-3b")
    js = jengine.init_serve_state(japi, 2, 6, dtype=jnp.float32, filled=4)
    ts = tengine.init_serve_state(tapi, 2, 6, dtype=torch.float32, filled=4, device="cpu")
    assert ts.cache_pos == int(js.cache_pos) == 4
    np.testing.assert_array_equal(ts.caches["scan"]["pos0"].pos.numpy(),
                                  np.asarray(js.caches["scan"]["pos0"].pos))


def _lines(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def check_launcher(monkeypatch, arch: str) -> None:
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "4", "--steps", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = _lines(jlaunch.main)
    got = _lines(lambda: tlaunch.main([*args, "--device", "cpu"]))
    pattern = rf"{re.escape(arch)}: 6 tokens in \d+\.\d\ds"
    assert re.fullmatch(pattern, want[0]) and re.fullmatch(pattern, got[0])
    rows = [np.array(line.strip(" []").split(), dtype=np.int64) for line in got[1:]]
    assert len(got) == len(want) == 3 and all(r.shape == (3,) for r in rows)
    assert all(((r >= 0) & (r < 257)).all() for r in rows)


def test_launcher_prints_the_reference_lines(monkeypatch):
    check_launcher(monkeypatch, "llama3.2-3b")


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_moe_launcher_prints_the_reference_lines(monkeypatch, arch):
    check_launcher(monkeypatch, arch)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_recurrent_launcher_prints_the_reference_lines(monkeypatch, arch):
    check_launcher(monkeypatch, arch)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-large-v3"])
def test_unported_families_raise_naming_their_roadmap_item(monkeypatch, arch):
    """The VLM (M-RoPE) and the encoder-decoder, once unported, now run the
    launcher as the reference does."""
    check_launcher(monkeypatch, arch)
