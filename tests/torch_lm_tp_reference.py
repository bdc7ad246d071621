"""The reference's own sharded LM train step on a 2 × 2 ``(data, model)``
mesh of host devices, for ``tests/test_torch_lm_tp_train*.py``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_lm_tp_reference.py OUT.pkl llama3.2-3b

JAX fixes its device count at its first use, so this runs in a process of
its own, with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set
before JAX is imported.  For each arch (its smoke config) and each AdamW
mode (unfactored, factored) it writes, as numpy: the initial train state
(``init_train_state`` with key 0) and its AdamW settings, the global
batch, the loss and grads of
``lm_loss`` over the whole batch, and the params and metrics after one
``make_train_step`` of 2 microbatches, each jitted with the state and the
batch placed by ``param_shardings(mesh, make_rules(fsdp=True), ...)`` (the
``tp`` posture: heads, FFN dims, experts and vocab over ``model``, the
``embed`` dim of every weight over ``data``) and XLA's partitioner laying
the program out.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

B, S, MICRO, LR = 8, 16, 2, 1e-2
# the AdamW modes, weight decay off.  The unfactored first update is
# lr·g/(|g| + eps); at the default eps 1e-8 a smoke config's grads of 1e-6
# and less (a fifth of them) sit where it divides by about eps, and a grad
# error at the tests' 1e-5 tolerance moves such an element by up to lr.
# eps 1e-3 keeps that update's slope under lr/eps at every element.
MODES = {"adamw": {"eps": 1e-3}, "factored": {"factored": True}}


def batch_of(arch: str):
    """The global batch: ``[B, S+1]`` tokens from a seeded numpy generator."""
    import numpy as np

    from repro.configs import smoke_config

    rng = np.random.default_rng(sum(map(ord, arch)))
    return {"tokens": rng.integers(0, smoke_config(arch).vocab_size, (B, S + 1), dtype=np.int32)}


def run(arch: str, mode: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding

    from repro.configs import smoke_config
    from repro.dist.sharding import make_rules, param_shardings, use_rules
    from repro.launch.mesh import make_mesh
    from repro.models.lm.api import build
    from repro.optim import AdamWConfig
    from repro.train import lm_loss, make_train_step
    from repro.train.step import init_train_state, train_state_axes

    api = build(smoke_config(arch))
    opt = AdamWConfig(lr=LR, weight_decay=0.0, **MODES[mode])
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = make_rules(fsdp=True)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    with mesh, use_rules(rules):
        state = init_train_state(api, jax.random.key(0), opt)
        first = to_np(state)
        state_sh = param_shardings(mesh, rules, train_state_axes(api, opt, state.params))
        batch = {k: jnp.asarray(v) for k, v in batch_of(arch).items()}
        batch_sh = {k: NamedSharding(mesh, rules.spec(("act_batch", None))) for k in batch}
        state = jax.device_put(state, state_sh)
        batch = jax.device_put(batch, batch_sh)
        vg = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(api, p, b), has_aux=True),
                     in_shardings=(state_sh.params, batch_sh))
        (_, metrics), grads = vg(state.params, batch)
        step = jax.jit(make_train_step(api, opt, microbatches=MICRO,
                                       lr_schedule=lambda s: jnp.asarray(LR)),
                       in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
        new, step_metrics = step(state, batch)
    return {"opt": dict(lr=LR, weight_decay=0.0, **MODES[mode]),
            "state": [first.params, first.opt, first.step], "batch": batch_of(arch),
            "loss": float(metrics["loss"]), "grads": to_np(grads),
            "params": to_np(new.params),
            "metrics": {k: float(v) for k, v in step_metrics.items()}}


def main(out: str, archs: list[str]) -> None:
    with open(out, "wb") as f:
        pickle.dump({(a, m): run(a, m) for a in archs for m in MODES}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
