"""LM training over a data mesh of 2 CPU ranks (4 in
``test_torch_lm_train_data4.py``, which runs these tests again) (gloo,
``torch.multiprocessing.spawn``, ``file://`` rendezvous) against the JAX
package's one-device step and the port's one-process step, on the same
global batch: the smoke configs of llama3.2-3b and dbrx-132b at float32
(dbrx with remat ``full``, so that the balance loss's all-reduce also runs
in the recompute).

Each rank takes its share of each microbatch's rows (``train.step.data_rows``)
and the grads are summed over the data group after the microbatches
(``make_train_step(..., mesh=)``).  Tolerances:

* against the reference: the loss at rtol 1e-5, each accumulated grad
  leaf within 1e-4 of its largest magnitude, one step's params and grad
  norm at ``tests/test_torch_lm_train_micro.py``'s step tolerances
  (rtol 5e-4, atol 5e-5; rtol 1e-4);
* against the port's one-process step: the loss within 1e-6 relative,
  each grad leaf within 1e-5 of its largest magnitude;
* dbrx's aux loss at rtol 1e-5 (atol 1e-7) of the reference's over the
  whole microbatch; a rank's contiguous n-th of the global batch would
  give another aux, far outside it (``test_a_contiguous_split_changes_the_aux``);
* the replicas bitwise equal after 3 steps;
* ``grad_dtype="bfloat16"`` (bf16 on the wire, float32 accumulators) within
  ``BF16_REL`` of each leaf's largest magnitude of the float32 wire.

This module imports no JAX at the top: the spawned ranks import it.
"""
import dataclasses
import datetime
import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2  # the ranks of the data mesh (the module's; test_torch_lm_train_data4.py: 4)
SPAWN_TIMEOUT_S = 120
ARCHS = ("llama3.2-3b", "dbrx-132b")
OVERRIDES = {"llama3.2-3b": {}, "dbrx-132b": {"remat": "full"}}
B, S, MICRO = 8, 16, 2  # one row a rank and microbatch at 4 ranks
LR = 1e-2
GRAD_REL = 1e-4       # vs the reference (float32 sums in other orders)
ONE_REL = 1e-5        # vs the port's one-process step
ONE_LOSS_REL = 1e-6
# each microbatch's grads rounded to bf16 (2^-9 of a value), and the ranks'
# sum rounded to bf16 on the wire at each of its n - 1 additions
BF16_REL = 2 ** -6
STEPS = 3


def _cfg(arch, pkg="repro_torch"):
    import importlib

    smoke = importlib.import_module(f"{pkg}.configs").smoke_config
    return dataclasses.replace(smoke(arch), **OVERRIDES[arch])


def _batches(arch):
    """The global batches of the steps (numpy, from ``SyntheticLMData``),
    handed to both packages: the first one is also the grads'."""
    from repro_torch.data import SyntheticLMData

    cfg = _cfg(arch)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=3)
    return [{k: v.numpy() for k, v in data.next().items()} for _ in range(STEPS)]


def _worker(rank: int, world: int, init_file: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.convert import lm_params_from_numpy, lm_train_state_from_numpy
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.models.lm.api import build
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import make_train_step
        from repro_torch.train.step import loss_and_grads
        from repro_torch.tree import tree_map

        mesh = make_data_mesh(world, device_type="cpu")
        given = torch.load(inputs, weights_only=False)
        res = {"coord": mesh.get_local_rank("data")}
        opt = AdamWConfig(lr=LR, weight_decay=0.0)
        for arch in ARCHS:
            api = build(_cfg(arch))
            params, opt_state, step0 = given[arch]["state"]
            batches = [lm_params_from_numpy(b, device="cpu") for b in given[arch]["batches"]]
            for wire in ((None, "bfloat16") if arch == "llama3.2-3b" else (None,)):
                res[f"{arch}/grads/{wire}"] = loss_and_grads(
                    api, lm_params_from_numpy(params, device="cpu"), batches[0],
                    microbatches=MICRO, grad_dtype=wire, mesh=mesh)
            step = make_train_step(api, opt, microbatches=MICRO, mesh=mesh,
                                   lr_schedule=lambda s: torch.tensor(LR))
            state = lm_train_state_from_numpy(params, opt_state, step0, device="cpu")
            hist = []
            for i, b in enumerate(batches):
                state, m = step(state, b)
                hist.append({k: float(v) for k, v in m.items()})
                if i == 0:  # the step writes in place: keep a copy
                    res[f"{arch}/step1"] = (tree_map(lambda t: t.clone(), state.params), m)
            res[f"{arch}/steps"] = (state.params, hist)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's init state (key 0, AdamW lr 1e-2) and batches of each
    arch, as numpy, in a file the ranks read."""
    given = _given()
    path = tmp_path_factory.mktemp("inputs") / "inputs.pt"
    torch.save(given, path)
    return given, str(path)


@pytest.fixture(scope="module")
def ranks(request, inputs, tmp_path_factory):
    world = request.module.WORLD
    out = tmp_path_factory.mktemp(f"data{world}")
    ctx = mp.spawn(_worker, args=(world, str(out / "rendezvous"), inputs[1], str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return world, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache
def _given():
    """The inputs of the ranks (numpy; deterministic), for the reference."""
    import jax

    from repro.models.lm.api import build as jbuild
    from repro.optim import AdamWConfig as JOpt
    from repro.optim import init_opt_state

    given = {}
    for arch in ARCHS:
        # the reference's init_train_state, its init jitted (the same draws, in a third
        # of the time)
        params = jax.jit(jbuild(_cfg(arch, "repro")).init)(jax.random.key(0))
        opt = init_opt_state(params, JOpt(lr=LR, weight_decay=0.0))
        state = (params, opt, np.zeros((), np.int32))
        given[arch] = {"state": [jax.tree.map(np.asarray, t) for t in state],
                       "batches": _batches(arch)}
    return given


@functools.lru_cache
def _reference_microbatches(arch):
    """The reference's microbatch arithmetic over the global batch: 0 + g₁ +
    … + gₘ in float32, ÷ m; the loss and aux loss averaged alike."""
    import jax
    import jax.numpy as jnp

    from repro.models.lm.api import build as jbuild
    from repro.train import lm_loss as jlm_loss

    given = _given()
    api = jbuild(_cfg(arch, "repro"))
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(api, p, b), has_aux=True))
    params = jax.tree.map(jnp.asarray, given[arch]["state"][0])
    batch = given[arch]["batches"][0]
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    loss = aux = 0.0
    rows = B // MICRO
    for i in range(MICRO):
        (_, m), g = vg(params, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                                for k, v in batch.items()})
        acc = jax.tree.map(lambda x, y: x + y.astype(jnp.float32), acc, g)
        loss, aux = loss + m["loss"], aux + m["aux_loss"]
    return jax.tree.map(lambda g: g / MICRO, acc), float(loss / MICRO), float(aux / MICRO)


def _one_process(arch, given, *, rows=None):
    """The port's one-process ``loss_and_grads`` over the global batch (its
    rows reordered by ``rows`` when given)."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.lm.api import build
    from repro_torch.train.step import loss_and_grads

    batch = lm_params_from_numpy(given[arch]["batches"][0], device="cpu")
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    return loss_and_grads(build(_cfg(arch)), lm_params_from_numpy(given[arch]["state"][0],
                                                                  device="cpu"),
                          batch, microbatches=MICRO)


def _worst(got, want) -> float:
    """max over leaves of max |got - want| / max |want|."""
    from repro_torch.tree import tree_leaves

    return max(float((g.float() - w.float()).abs().max()) / max(float(w.abs().max()), 1e-12)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def test_the_mesh_is_the_data_mesh(ranks):
    world, results = ranks
    assert sorted(r["coord"] for r in results) == list(range(world))


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_grads_match_the_reference(ranks, arch):
    from test_torch_lm_train_loss import assert_grads_close

    _, results = ranks
    want, wloss, waux = _reference_microbatches(arch)
    for r in results:
        grads, m = r[f"{arch}/grads/None"]
        np.testing.assert_allclose(float(m["loss"]), wloss, rtol=1e-5)
        np.testing.assert_allclose(float(m["aux_loss"]), waux, rtol=1e-5, atol=1e-7)
        assert_grads_close(grads, want, rel=GRAD_REL)
    if arch == "dbrx-132b":
        assert waux > 0


@functools.lru_cache
def _reference_step(arch):
    """(params by key, metrics) of the reference's one-device step."""
    import jax
    import jax.numpy as jnp

    from repro.models.lm.api import build as jbuild
    from repro.optim import AdamWConfig as JOpt
    from repro.train import make_train_step as jmake_step
    from repro.train.step import TrainState as JState

    given = _given()[arch]
    jstep = jmake_step(jbuild(_cfg(arch, "repro")), JOpt(lr=LR, weight_decay=0.0),
                       microbatches=MICRO, lr_schedule=lambda s: jnp.asarray(LR))
    jstate = JState(*jax.tree.map(jnp.asarray, given["state"]))
    jb, jm = jstep(jstate, jax.tree.map(jnp.asarray, given["batches"][0]))
    return ({jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jb.params)[0]},
            {k: float(v) for k, v in jm.items()})


def test_data_parallel_step_matches_the_reference_step(ranks):
    """One step of ``make_train_step(..., mesh=)`` against the reference's
    ``make_train_step`` on one device, llama's, whose one-process step
    ``test_torch_lm_train_micro.py`` holds to these tolerances.  (Adam's
    first update, lr·g/(|g| + eps), turns a grad near eps into a large
    relative change: dbrx's one-process step already comes within 1e-7 of
    the atol on one element of ``wq``, so its grads are held instead.)"""
    from repro_torch.tree import tree_leaves_with_path

    arch = "llama3.2-3b"
    _, results = ranks
    want, jm = _reference_step(arch)
    for r in results:
        params, m = r[f"{arch}/step1"]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for k, x in tree_leaves_with_path(params):
            np.testing.assert_allclose(x.numpy(), want[k.replace("/", "")], rtol=5e-4, atol=5e-5,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_grads_match_one_process(ranks, inputs, arch):
    _, results = ranks
    want, wm = _one_process(arch, inputs[0])
    for r in results:
        grads, m = r[f"{arch}/grads/None"]
        assert abs(float(m["loss"]) - float(wm["loss"])) <= ONE_LOSS_REL * float(wm["loss"])
        assert _worst(grads, want) <= ONE_REL


def test_a_contiguous_split_changes_the_aux(ranks, inputs):
    """Had each rank taken a contiguous n-th of the global batch, microbatch
    i would hold other rows, and dbrx's aux loss would leave the
    reference's tolerance: the test above tells the two splits apart."""
    world, results = ranks
    k = B // (MICRO * world)
    # microbatch i of a contiguous split: block i of each rank's n-th
    rows = [r * (B // world) + i * k + j for i in range(MICRO) for r in range(world)
            for j in range(k)]
    assert rows != list(range(B))
    _, m = _one_process("dbrx-132b", inputs[0], rows=rows)
    _, _, waux = _reference_microbatches("dbrx-132b")
    assert abs(float(m["aux_loss"]) - waux) > 1e-5 * waux + 1e-7


@pytest.mark.parametrize("arch", ARCHS)
def test_replicas_stay_bitwise_equal(ranks, arch):
    from repro_torch.tree import tree_leaves

    _, results = ranks
    first, hist = results[0][f"{arch}/steps"]
    assert len(hist) == STEPS and all(np.isfinite(h["loss"]) for h in hist)
    for r in results[1:]:
        params, h = r[f"{arch}/steps"]
        assert h == hist
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(first)))


def test_bf16_wire_is_close_to_the_float32_wire(ranks):
    from repro_torch.tree import tree_leaves

    _, results = ranks
    for r in results:
        g32, m32 = r["llama3.2-3b/grads/None"]
        g16, m16 = r["llama3.2-3b/grads/bfloat16"]
        assert all(g.dtype == torch.float32 for g in tree_leaves(g16))
        assert float(m16["loss"]) == float(m32["loss"])
        assert 0 < _worst(g16, g32) <= BF16_REL
        first = results[0]["llama3.2-3b/grads/bfloat16"][0]
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g16), tree_leaves(first)))
