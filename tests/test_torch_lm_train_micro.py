"""Microbatch accumulation and compressed gradients against the JAX
package's arithmetic and train step (llama3.2-3b's, dbrx-132b's and
whisper-large-v3's smoke configs; the helpers of
``test_torch_lm_train_loss.py``).  Tolerances: the accumulated grads
within 1e-4 of each leaf's largest magnitude (one bf16 step, 2^-7, where
each microbatch's grads are rounded to bf16); one train step at the
reference tests' tolerances (``tests/test_train.py:105``,
``tests/test_serving_extras.py:80``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.api import build as jbuild
from repro.optim import AdamWConfig as JOpt
from repro.train import make_train_step as jmake_step
from repro.train.step import TrainState as JState
from repro.train.step import init_train_state as jinit_state
from repro_torch.convert import lm_params_from_numpy, lm_train_state_from_numpy
from repro_torch.models.lm.api import build as tbuild
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_leaves_with_path
from test_torch_lm_train_loss import (  # noqa: F401  (one_thread: an autouse fixture)
    GRAD_REL,
    assert_grads_close,
    batch_of,
    jvalue_and_grad,
    one_thread,
    shared_params,
    smoke_pair,
    to_torch,
)


def _jax_accumulated(jcfg, jparams, batch, n, gdt=None):
    """The reference's microbatch arithmetic, spelled out: 0 + g₁ + … + gₙ
    in float32 (each gᵢ rounded to ``gdt`` first), then ÷ n."""
    vg = jvalue_and_grad(jcfg)
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    loss = jnp.zeros((), jnp.float32)
    rows = batch["tokens"].shape[0] // n
    for i in range(n):
        mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows]) for k, v in batch.items()}
        (_, m), g = vg(jparams, mb)
        if gdt is not None:
            g = jax.tree.map(lambda x: x.astype(gdt), g)
        acc = jax.tree.map(lambda x, y: x + y.astype(jnp.float32), acc, g)
        loss = loss + m["loss"]
    return jax.tree.map(lambda g: g / n, acc), loss / n


@pytest.mark.parametrize("arch,grad_dtype", [("llama3.2-3b", None), ("llama3.2-3b", "bfloat16"),
                                             ("dbrx-132b", None), ("whisper-large-v3", None)])
def test_microbatched_grads_match_the_reference_arithmetic(arch, grad_dtype):
    jcfg, tcfg = smoke_pair(arch)
    jparams, nparams = shared_params(jcfg)
    batch = batch_of(jcfg, b=4)
    want, wloss = _jax_accumulated(jcfg, jparams, batch, 4,
                                   jnp.bfloat16 if grad_dtype else None)
    grads, m = loss_and_grads(tbuild(tcfg), lm_params_from_numpy(nparams, device="cpu"),
                              to_torch(batch), microbatches=4, grad_dtype=grad_dtype)
    assert all(g.dtype == torch.float32 for _, g in tree_leaves_with_path(grads))
    np.testing.assert_allclose(float(m["loss"]), float(wloss), rtol=1e-5)
    # a bf16 rounding of two runs' grads can fall on either side: one bf16 ulp
    assert_grads_close(grads, want, rel=2 ** -7 if grad_dtype else GRAD_REL)


def _steps(jcfg, tcfg, batch, runs: dict):
    """One step of the port's ``make_train_step`` for each entry of
    ``runs`` (name -> its keywords), each from the reference's
    ``init_train_state`` (key 0) carried across, on ``batch``."""
    opt = dict(lr=1e-2, weight_decay=0.0)
    js = jinit_state(jbuild(jcfg), jax.random.key(0), JOpt(**opt))
    state = [jax.tree.map(np.asarray, t) for t in (js.params, js.opt, js.step)]
    out = {}
    for name, kw in runs.items():
        step = make_train_step(tbuild(tcfg), AdamWConfig(**opt),
                               lr_schedule=lambda s: torch.tensor(1e-2), **kw)
        out[name] = step(lm_train_state_from_numpy(*state, device="cpu"), to_torch(batch))
    return out, JState(*jax.tree.map(jnp.asarray, state)), JOpt(**opt)


def test_train_step_microbatches_4_equal_1():
    """4 microbatches against 1 on the same batch at ``tests/test_train.py``'s
    tolerance (its data: seed 7, 16 x 16 tokens), and the port's 4 against
    the reference's own step."""
    jcfg, tcfg = smoke_pair("llama3.2-3b")
    batch = batch_of(jcfg, b=16, seed=7)
    out, jstate, jopt = _steps(jcfg, tcfg, batch, {1: dict(microbatches=1),
                                                   4: dict(microbatches=4)})
    (a, ma), (b, mb) = out[1], out[4]
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    for (k, x), (_, y) in zip(tree_leaves_with_path(a.params), tree_leaves_with_path(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=5e-4, atol=5e-5, err_msg=k)
    jstep = jmake_step(jbuild(jcfg), jopt, microbatches=4, lr_schedule=lambda s: jnp.asarray(1e-2))
    jb, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(mb["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mb["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(b.step) == int(jb.step) == 1 and int(b.opt["count"]) == 1


def test_gradient_compression_close_to_fp32():
    """``grad_dtype="bfloat16"`` against float32 grads, 2 microbatches, at
    ``tests/test_serving_extras.py``'s tolerances (its data: seed 3, 8 x
    16), and against the reference's compressed step."""
    jcfg, tcfg = smoke_pair("llama3.2-3b")
    batch = batch_of(jcfg, b=8, seed=3)
    out, jstate, jopt = _steps(jcfg, tcfg, batch, {
        "f32": dict(microbatches=2), "bf16": dict(microbatches=2, grad_dtype="bfloat16")})
    (a, ma), (b, mb) = out["f32"], out["bf16"]
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    gn32, gnbf = float(ma["grad_norm"]), float(mb["grad_norm"])
    assert abs(gn32 - gnbf) / gn32 < 0.05, (gn32, gnbf)
    for (k, x), (_, y) in zip(tree_leaves_with_path(a.params), tree_leaves_with_path(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0.5, atol=2e-2, err_msg=k)
    jstep = jmake_step(jbuild(jcfg), jopt, microbatches=2, lr_schedule=lambda s: jnp.asarray(1e-2),
                       grad_dtype="bfloat16")
    _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(mb["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(gnbf, float(jm["grad_norm"]), rtol=1e-3)
