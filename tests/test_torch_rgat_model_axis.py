"""R-GAT over a (lane, model) mesh of 2 and 4 CPU ranks (gloo,
``torch.multiprocessing.spawn``, ``file://`` rendezvous), against the
one-process port and the reference's ``jax.grad``.

The problem is the reference launcher's (synthetic acm at scale 0.05,
B = 16, its metapath graphs), R-GAT at hidden 8, heads 2, layers 2 (a
model rank holds one head at model 2), weights made by the reference's
``init_rgat`` and carried across through ``convert``.  Each mesh spawns
once (a module fixture, bounded by a timeout); every rank computes:

* the logits, the loss and the gathered gradients of
  ``rgat_forward(mesh=, placements=)`` on BLOCK and MULTIGRAPH (kernels
  #1/#2 at G = 1), within 1e-5 of each leaf's largest magnitude of the
  one-process port, and on BLOCK of the reference's ``jax.grad``;
  bitwise equal across the ranks of a model group and bitwise repeatable;
* ``run_training(model_name="R-GAT", model_split=M)`` lowering the loss;
* elastic restarts: a checkpoint written on the mesh resumes in one
  process, and one written in one process resumes on the mesh, each with
  the next loss of the run it left within 1e-6.

The placements of R-GAT's leaves are the reference's ``hgnn_param_axes``
under its ``lanes`` rules, leaf by leaf.
"""
import datetime
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240
REL_TOL = 1e-5   # max |Δ| over the leaf's largest magnitude
LOSS_TOL = 1e-6  # the next loss after an elastic restart
BACKENDS = ("block", "multigraph")
PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
WIDTH = dict(hidden=8, heads=2, layers=2)
RUN = dict(dataset="acm", model_name="R-GAT", backend="kernel", hidden=8, heads=2, log_every=1,
           device="cpu", ckpt_every=2, **PROBLEM)


def _path(path) -> str:
    """JAX's key path as the port's ``tree_leaves_with_path`` spells it."""
    return "/".join(str(p) for p in path)


# The reference is imported where it is used: each spawned rank imports this
# module to find its worker, and needs neither JAX nor the reference.

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's R-GAT weights, saved for the ranks; its loss and
    ``jax.grad`` on BLOCK come with :func:`_jax_grad`."""
    import jax

    from repro.launch.hgnn_train import build_problem as jbuild_problem
    from repro.models.hgnn import MODELS as JMODELS

    _, jdata = jbuild_problem("acm", **PROBLEM)
    jparams = JMODELS["R-GAT"].init(jax.random.key(0), jdata, **WIDTH)
    out = tmp_path_factory.mktemp("rgat_ref") / "params.pt"
    torch.save(jax.tree_util.tree_map(np.asarray, jparams), out)
    return dict(params_file=str(out), params=jparams, data=jdata)


def _jax_grad(reference: dict) -> None:
    """The reference's loss and ``jax.grad`` on BLOCK, leaves by path, into
    ``reference`` (once: the ranks run meanwhile)."""
    if "grads" in reference:
        return
    import jax

    from repro.core import NABackend as JNA
    from repro.models.hgnn import MODELS as JMODELS
    from repro.models.hgnn import cross_entropy as jcross_entropy

    jdata = reference["data"]

    def jloss(p):
        return jcross_entropy(JMODELS["R-GAT"].forward(p, jdata, backend=JNA.BLOCK), jdata.labels)

    loss, grads = jax.jit(jax.value_and_grad(jloss))(reference["params"])
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    reference.update(loss=float(loss),
                     grads={_path(p): torch.from_numpy(np.array(g)) for p, g in flat})


def _worker(rank: int, lanes: int, model: int, init_file: str, out_dir: str,
            params_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=lanes * model,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.convert import params_from_numpy
        from repro_torch.core import NABackend
        from repro_torch.dist import gather_leaf, local_slice, make_rules, map_placements
        from repro_torch.dist import param_shardings, placement_leaves
        from repro_torch.launch import hgnn_train
        from repro_torch.launch.mesh import make_lane_mesh
        from repro_torch.models.hgnn import cross_entropy, rgat_forward
        from repro_torch.train import hgnn_param_axes
        from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten

        mesh = make_lane_mesh(lanes, model, device_type="cpu")
        _, data = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
        params = params_from_numpy(torch.load(params_file, weights_only=False), device="cpu")
        pl = param_shardings(mesh, make_rules(parallelism="lanes"), hgnn_param_axes(params))
        paths = [k for k, _ in tree_leaves_with_path(params)]
        res = {"coord": (mesh.get_local_rank("lane"), mesh.get_local_rank("model")),
               "placements": dict(zip(paths, (tuple(map(repr, p))
                                              for p in placement_leaves(pl)))),
               "local_shapes": dict(zip(paths, (tuple(x.shape) for x in tree_leaves(
                   map_placements(lambda p, x: local_slice(x, p, mesh), pl, params)))))}

        def run(tree, **kw):
            tree = map_placements(lambda p, x: x.detach().clone().requires_grad_(), pl, tree)
            leaves = tree_leaves(tree)
            logits = rgat_forward(tree, data, **kw)
            loss = cross_entropy(logits, data.labels)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)  # unused: zeros, as jax.grad
            grads = tree_unflatten(tree, [torch.zeros_like(x) if g is None else g
                                          for x, g in zip(leaves, grads)])
            return logits.detach(), loss.detach(), grads

        for name in BACKENDS:
            backend = NABackend(name)
            logits, loss, grads = run(params, backend=backend)
            res[f"one/{name}"] = (logits, loss, dict(zip(paths, tree_leaves(grads))))
            for again in ("sharded", "again"):
                local = map_placements(lambda p, x: local_slice(x, p, mesh), pl, params)
                logits, loss, grads = run(local, backend=backend, mesh=mesh, placements=pl)
                whole = map_placements(lambda p, g: gather_leaf(g, p, mesh), pl, grads)
                res[f"{again}/{name}"] = (logits, loss, dict(zip(paths, tree_leaves(whole))))

        # training over the mesh, one rank writing
        ckpt = os.path.join(out_dir, "mesh")
        mesh_run = dict(RUN, lanes=lanes, model_split=model, log=lambda *_: None)
        _, hist, meta = hgnn_train.run_training(steps=4, ckpt_dir=ckpt, **mesh_run)
        res["losses"] = [h["loss"] for h in hist]
        res["meta"] = meta
        dist.barrier()
        res["ckpt_steps"] = sorted(os.listdir(ckpt)) if rank == 0 else None
        # elastic: the mesh's step-4 checkpoint continued on the mesh and in one process
        if rank == 0:
            shutil.copytree(ckpt, os.path.join(out_dir, "mesh_to_one"))
        dist.barrier()
        _, hist, _ = hgnn_train.run_training(steps=5, ckpt_dir=ckpt, **mesh_run)
        res["mesh_next"] = [(h["step"], h["loss"]) for h in hist]
        # a one-process checkpoint, continued in one process and on the mesh
        if rank == 0:
            one_run = dict(RUN, log=lambda *_: None)
            _, hist, _ = hgnn_train.run_training(steps=5, ckpt_dir=os.path.join(
                out_dir, "mesh_to_one"), **one_run)
            res["one_from_mesh"] = [(h["step"], h["loss"]) for h in hist]
            one = os.path.join(out_dir, "one")
            hgnn_train.run_training(steps=4, ckpt_dir=one, **one_run)
            shutil.copytree(one, os.path.join(out_dir, "one_to_mesh"))
            _, hist, _ = hgnn_train.run_training(steps=5, ckpt_dir=one, **one_run)
            res["one_next"] = [(h["step"], h["loss"]) for h in hist]
        dist.barrier()
        _, hist, _ = hgnn_train.run_training(
            steps=5, ckpt_dir=os.path.join(out_dir, "one_to_mesh"), **mesh_run)
        res["mesh_from_one"] = [(h["step"], h["loss"]) for h in hist]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=lambda m: f"lane{m[0]}xmodel{m[1]}")
def ranks(request, reference, tmp_path_factory):
    lanes, model = request.param
    out = tmp_path_factory.mktemp(f"rgat{lanes}x{model}")
    ctx = mp.spawn(_worker, args=(lanes, model, str(out / "rendezvous"), str(out),
                                  reference["params_file"]),
                   nprocs=lanes * model, join=False)
    _jax_grad(reference)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{lanes} x {model} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return (lanes, model), [torch.load(out / f"rank{r}.pt", weights_only=False)
                            for r in range(lanes * model)]


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape, what
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max()), what


def test_placements_are_the_references_axes_under_the_lanes_rules(ranks, reference):
    """Leaf by leaf: the model dimension shards the tensor dim that the
    reference's spec puts on ``model``; the lane dimension shards none."""
    import jax

    import repro.dist.sharding as jsh
    from repro.train.hgnn import hgnn_param_axes as jparam_axes

    (_, model), results = ranks
    rules = jsh.make_rules(parallelism="lanes")
    flat = jax.tree_util.tree_flatten_with_path(jparam_axes(reference["params"]),
                                                is_leaf=lambda a: isinstance(a, tuple))[0]
    want = {}
    for path, axes in flat:
        spec = tuple(rules.spec(axes)) + (None,) * (len(axes) - len(rules.spec(axes)))
        model_dim = [i for i, e in enumerate(spec) if e == "model"]
        want[_path(path)] = ("Replicate()",
                             f"Shard(dim={model_dim[0]})" if model_dim else "Replicate()")
    got = results[0]["placements"]
    assert list(got) == list(want)
    assert got == want
    # finding 2 of the reference's table: w_src/w_dst by columns, w_out by rows,
    # the 2-D a_src/a_dst (the table gives them three axes), self and b_out whole
    rel = "['layers']/[0]/['rel']/['g0']"
    assert got[f"{rel}/['w_src']"][1] == got[f"{rel}/['w_dst']"][1] == "Shard(dim=1)"
    assert got["['w_out']"][1] == "Shard(dim=0)"
    assert (got[f"{rel}/['a_src']"][1] == got[f"{rel}/['a_dst']"][1] == got["['b_out']"][1]
            == "Replicate()")
    assert all(v[1] == "Replicate()" for k, v in got.items() if "/['self']/" in k)
    shapes = results[0]["local_shapes"]
    assert shapes[f"{rel}/['w_src']"][1] == WIDTH["heads"] * WIDTH["hidden"] // model
    assert shapes["['w_out']"][0] == WIDTH["heads"] * WIDTH["hidden"] // model


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_rgat_agrees_with_one_process_and_jax_grad(ranks, reference, backend):
    _, results = ranks
    for r in results:
        one_logits, one_loss, one_grads = r[f"one/{backend}"]
        logits, loss, grads = r[f"sharded/{backend}"]
        _close(logits, one_logits, "logits")
        assert abs(float(loss) - float(one_loss)) <= REL_TOL * abs(float(one_loss))
        assert abs(float(loss) - reference["loss"]) <= REL_TOL * abs(reference["loss"])
        assert list(grads) == list(one_grads) == list(reference["grads"])
        for k, g in grads.items():
            _close(g, one_grads[k], k)
            # layer 1's a_dst gradient vanishes (θ_dst shifts all of a row's logits
            # alike): BLOCK gives exact zeros in both packages, #2 float32 noise, so
            # MULTIGRAPH is held to jax.grad through the one-process port
            # (tests/test_torch_rgat_grads.py holds that against MULTIGRAPH_INTERPRET)
            if backend == "block":
                _close(g, reference["grads"][k], f"{k} vs jax.grad")


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_group_ranks_agree_bitwise_and_runs_repeat(ranks, backend):
    _, results = ranks
    first = results[0][f"sharded/{backend}"]
    for r in results:
        logits, loss, grads = r[f"sharded/{backend}"]
        again = r[f"again/{backend}"]
        assert torch.equal(logits, again[0]) and torch.equal(loss, again[1])
        assert all(torch.equal(g, again[2][k]) for k, g in grads.items())
        # R-GAT runs replicated over the lane axis: every rank of the mesh agrees
        assert torch.equal(logits, first[0]) and torch.equal(loss, first[1])
        assert all(torch.equal(g, first[2][k]) for k, g in grads.items())


def test_run_training_over_the_mesh_lowers_the_loss(ranks):
    (lanes, model), results = ranks
    for r in results:
        assert r["losses"][-1] < r["losses"][0] and r["losses"] == results[0]["losses"]
        assert r["meta"]["model"] == "R-GAT" and r["meta"]["backend"] == "multigraph"
        assert r["meta"]["lanes"] == lanes and r["meta"]["model_split"] == model
    assert results[0]["ckpt_steps"] == ["step_2", "step_4"]


def test_elastic_restart_across_model_splits(ranks):
    _, results = ranks
    rank0 = results[0]
    (s_mesh, mesh_next), = rank0["mesh_next"]
    (s_one, one_from_mesh), = rank0["one_from_mesh"]
    assert s_mesh == s_one == 4 and abs(mesh_next - one_from_mesh) <= LOSS_TOL
    (s_one, one_next), = rank0["one_next"]
    (s_mesh, mesh_from_one), = rank0["mesh_from_one"]
    assert s_mesh == s_one == 4 and abs(one_next - mesh_from_one) <= LOSS_TOL
    assert all(r["mesh_from_one"] == rank0["mesh_from_one"] for r in results)
