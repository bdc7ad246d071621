"""The LM train step under the ``tp`` posture on a 2 × 2 ``(data, model)``
mesh of 4 CPU ranks (gloo, ``torch.multiprocessing.spawn``, ``file://``
rendezvous), against the reference's own sharded step on a 2 × 2 mesh of
host devices (``tests/torch_lm_tp_reference.py``, in a subprocess, which
also fixes the AdamW settings both take) under
``make_rules(fsdp=True)``: heads, FFN dims, experts and vocab over
``model``, the ``embed`` dim of every weight over ``data``.  llama3.2-3b's
smoke config here, dbrx-132b's (experts over ``model``) in
``test_torch_lm_tp_train_moe.py``, each with the unfactored and the
factored AdamW.

Each rank holds its pieces (``dist.local_slice`` of the reference's initial
state by ``dist.param_shardings``) and runs ``loss_and_grads`` and
``make_train_step`` with the mesh and the placements; the pieces are then
gathered into logical leaves.  Tolerances, each leaf within ``REL`` of its
largest magnitude: the loss, the grads over the whole batch, and the params
and grad norm after one step of 2 microbatches.  The ``fsdp`` leaves' grads
come summed over ``data`` out of the backward (a reduce-scatter): a mutant
that all-reduces them over ``data`` again doubles them, and the same check
fails on them (``test_summing_fsdp_grads_twice_fails``).  After 3 steps
every rank holds the same logical params, bit for bit.

This module imports no JAX: the reference runs in its subprocess.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH = "llama3.2-3b"  # test_torch_lm_tp_train_moe.py: dbrx-132b
MODES = ("adamw", "factored")
SHAPE = (2, 2)  # (data, model)
SPAWN_TIMEOUT_S = 120
REL = 1e-5
STEPS = 3
HERE = os.path.dirname(os.path.abspath(__file__))


def _logical(tree, placements, mesh):
    from repro_torch.dist import gather_leaf, map_placements

    return map_placements(lambda pl, x: gather_leaf(x, pl, mesh).detach().clone(),
                          placements, tree)


def _worker(rank: int, world: int, init_file: str, ref_path: str, arch: str,
            out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        import repro_torch.train.step as step_mod
        from repro_torch.checkpoint import reshard_to
        from repro_torch.configs import smoke_config
        from repro_torch.convert import lm_params_from_numpy, lm_train_state_from_numpy
        from repro_torch.dist import make_rules, param_shardings
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.lm.api import build
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import make_train_step
        from repro_torch.train.step import loss_and_grads, train_state_axes

        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        mesh = make_mesh(SHAPE, ("data", "model"), device_type="cpu")
        api = build(smoke_config(arch))
        res = {}
        for mode in MODES:
            given = ref[(arch, mode)]
            opt = AdamWConfig(**given["opt"])  # the reference's (its eps: see there)
            logical = lm_train_state_from_numpy(*given["state"], device="cpu")
            pl = param_shardings(mesh, make_rules(fsdp=True),
                                 train_state_axes(api, opt, logical.params))
            state = reshard_to(logical, mesh=mesh, placements=pl)
            batch = lm_params_from_numpy(given["batch"], device="cpu")
            grads, m = loss_and_grads(api, state.params, batch, mesh=mesh,
                                      placements=pl.params)
            out = {"loss": float(m["loss"]), "grads": _logical(grads, pl.params, mesh)}
            real = step_mod.data_sharded
            step_mod.data_sharded = lambda *_: False  # the mutant: fsdp grads summed twice
            try:
                twice, _ = loss_and_grads(api, state.params, batch, mesh=mesh,
                                          placements=pl.params)
            finally:
                step_mod.data_sharded = real
            out["twice"] = _logical(twice, pl.params, mesh)
            step = make_train_step(api, opt, microbatches=2, mesh=mesh, placements=pl,
                                   lr_schedule=lambda s: torch.tensor(opt.lr))
            hist = []
            for i in range(STEPS):
                state, m = step(state, batch)
                hist.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    out["step1"] = _logical(state.params, pl.params, mesh)
            out["hist"] = hist
            out["after"] = _logical(state.params, pl.params, mesh)
            res[mode] = out
        res["coord"] = tuple(mesh.get_coordinate())
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def reference(tmp_path_factory, arch: str) -> dict:
    """The reference's sharded results (its subprocess), as numpy."""
    path = tmp_path_factory.mktemp("reference") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, os.path.join(HERE, "torch_lm_tp_reference.py"), str(path),
                    arch], check=True, env=env, timeout=300)
    with open(path, "rb") as f:
        return pickle.load(f), str(path)


def spawn_ranks(tmp_path_factory, ref_path: str, arch: str) -> list[dict]:
    world = SHAPE[0] * SHAPE[1]
    out = tmp_path_factory.mktemp("tp")
    ctx = mp.spawn(_worker, args=(world, str(out / "rendezvous"), ref_path, arch, str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    arch = request.module.ARCH
    ref, path = reference(tmp_path_factory, arch)
    return ({mode: ref[(arch, mode)] for mode in MODES}, spawn_ranks(tmp_path_factory, path, arch),
            arch)


def by_path(tree) -> dict:
    from repro_torch.tree import tree_leaves_with_path

    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, dtype=np.float32)
            for k, v in tree_leaves_with_path(tree)}


def leaf_errors(got, want) -> dict:
    """max |got - want| / max |want| of each leaf, by path (numpy trees from
    the reference are converted to the port's tree first)."""
    from repro_torch.convert import lm_params_from_numpy

    w = by_path(lm_params_from_numpy(want, device="cpu"))
    g = by_path(got)
    assert g.keys() == w.keys()
    return {k: float(np.abs(g[k] - w[k]).max()) / max(float(np.abs(w[k]).max()), 1e-30)
            for k in w}


def fsdp_paths(arch: str) -> set:
    """The paths of the params leaves whose ``embed`` dim rides ``data``."""
    from repro_torch.configs import smoke_config
    from repro_torch.dist.sharding import map_axes
    from repro_torch.models.lm.api import build
    from repro_torch.tree import tree_leaves_with_path

    axes = build(smoke_config(arch)).axes()
    return {k for k, on in tree_leaves_with_path(map_axes(lambda a: "embed" in a, axes)) if on}


def test_the_ranks_cover_the_mesh(runs):
    _, ranks, _ = runs
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_the_reference_sharded_step(runs, mode):
    ref, ranks, _ = runs
    want = ref[mode]
    for r in ranks:
        np.testing.assert_allclose(r[mode]["loss"], want["loss"], rtol=REL)
        errs = leaf_errors(r[mode]["grads"], want["grads"])
        assert max(errs.values()) <= REL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_the_reference_sharded_step(runs, mode):
    ref, ranks, _ = runs
    want = ref[mode]
    for r in ranks:
        m = r[mode]["hist"][0]
        np.testing.assert_allclose(m["loss"], want["metrics"]["loss"], rtol=REL)
        np.testing.assert_allclose(m["grad_norm"], want["metrics"]["grad_norm"], rtol=REL)
        errs = leaf_errors(r[mode]["step1"], want["params"])
        assert max(errs.values()) <= REL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("mode", MODES)
def test_summing_fsdp_grads_twice_fails(runs, mode):
    """The mutant's fsdp leaves leave the tolerance (they come out doubled);
    its other leaves keep it."""
    ref, ranks, arch = runs
    fsdp = fsdp_paths(arch)
    assert fsdp
    errs = leaf_errors(ranks[0][mode]["twice"], ref[mode]["grads"])
    for k, e in errs.items():
        if k in fsdp:
            assert e > 0.5, k
        else:
            assert e <= REL, k


@pytest.mark.parametrize("mode", MODES)
def test_every_rank_holds_the_same_params(runs, mode):
    from repro_torch.tree import tree_leaves

    _, ranks, _ = runs
    first = ranks[0][mode]
    assert len(first["hist"]) == STEPS and all(np.isfinite(h["loss"]) for h in first["hist"])
    for r in ranks[1:]:
        assert r[mode]["hist"] == first["hist"]
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r[mode]["after"]),
                                                      tree_leaves(first["after"])))
