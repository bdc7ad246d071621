"""The model mesh axis over a ``torch.distributed`` group: HAN's parameters
and AdamW state sharded over a (lane, model) mesh of 2 and 4 CPU ranks
(gloo, ``torch.multiprocessing.spawn``, ``file://`` rendezvous).  No JAX:
the one-process port is the reference.

Each mesh spawns once (a module fixture, bounded by a timeout); every rank
computes, on small synthetic acm (scale 0.05, B = 16, HAN hidden 8, heads
2, so that a model rank holds one head at model 2), over a balanced plan
of 4 lanes:

* the mesh's lane group is the rank's lane subgroup, at a lane size of 1
  too;
* HAN's logits, loss and gathered gradients through
  ``han_forward_multilane(mesh=, placements=)`` on the kernel and fused_fp
  backends, against the one-process run within 1e-5 of each leaf's
  largest magnitude, bitwise equal across the ranks of a model group and
  bitwise repeatable; the gradient norm AdamW clips by, over the pieces,
  the one-process norm and the same on every rank;
* ``run_training`` over the mesh lowering the loss, one rank writing;
* elastic restarts: a checkpoint written on the mesh resumes in one
  process, and one written in one process resumes on the mesh, each with
  the next loss of the run it left within 1e-6.
"""
import datetime
import os
import shutil
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240
REL_TOL = 1e-5   # gathered gradients vs one process: max |Δ| over the leaf's largest magnitude
LOSS_TOL = 1e-6  # the next loss after an elastic restart
PLAN_LANES = 4
BACKENDS = ("kernel", "fused_fp")
PROBLEM = dict(scale=0.05, feat_scale=0.1, block=16, max_edges=20_000)
WIDTH = dict(hidden=8, heads=2, att_dim=16)
RUN = dict(dataset="acm", plan_lanes=PLAN_LANES, hidden=8, heads=2, log_every=1,
           device="cpu", ckpt_every=2, **PROBLEM)


def _worker(rank: int, lanes: int, model: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    world = lanes * model
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.core import build_multilane_plan
        from repro_torch.dist import gather_leaf, local_slice, make_rules, param_shardings
        from repro_torch.launch import hgnn_train
        from repro_torch.launch.mesh import make_lane_mesh
        from repro_torch.models.hgnn import cross_entropy, han_forward_multilane, init_han
        from repro_torch.optim import global_norm
        from repro_torch.train import hgnn_param_axes

        mesh = make_lane_mesh(lanes, model, device_type="cpu")
        lane_group = mesh.get_group("lane")
        res = {"coord": (mesh.get_local_rank("lane"), mesh.get_local_rank("model")),
               "lane_group": (dist.get_world_size(lane_group), dist.get_rank(lane_group))}
        _, data = hgnn_train.build_problem("acm", device="cpu", **PROBLEM)
        params = init_han(torch.Generator().manual_seed(0), data, **WIDTH)
        plan = build_multilane_plan(data.graphs, PLAN_LANES)
        pl = param_shardings(mesh, make_rules(parallelism="lanes"), hgnn_param_axes(params))
        res["local_shapes"] = {k: tuple(local_slice(v, pl[k], mesh).shape)
                               for k, v in params.items()}
        names = sorted(params)
        for backend in BACKENDS:
            whole = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
            logits = han_forward_multilane(whole, data, plan, backend=backend)
            loss = cross_entropy(logits, data.labels)
            grads = torch.autograd.grad(loss, [whole[k] for k in names])
            res[f"one/{backend}"] = (logits.detach(), loss.detach(), dict(zip(names, grads)))
            for run in ("sharded", "again"):
                local = {k: local_slice(v, pl[k], mesh).requires_grad_()
                         for k, v in params.items()}
                logits = han_forward_multilane(local, data, plan, mesh=mesh, placements=pl,
                                               backend=backend)
                loss = cross_entropy(logits, data.labels)
                grads = torch.autograd.grad(loss, [local[k] for k in names])
                res[f"{run}/{backend}"] = (
                    logits.detach(), loss.detach(),
                    {k: gather_leaf(g, pl[k], mesh) for k, g in zip(names, grads)})
                res[f"{run}/{backend}/norm"] = global_norm(dict(zip(names, grads)),
                                                           placements=pl, mesh=mesh)

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
def ranks(request, tmp_path_factory):
    lanes, model = request.param
    out = tmp_path_factory.mktemp(f"mesh{lanes}x{model}")
    ctx = mp.spawn(_worker, args=(lanes, model, str(out / "rendezvous"), str(out)),
                   nprocs=lanes * model, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{lanes} x {model} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return (lanes, model), [torch.load(out / f"rank{r}.pt", weights_only=False)
                            for r in range(lanes * model)]


def test_the_lane_group_is_the_ranks_lane_subgroup(ranks):
    (lanes, model), results = ranks
    assert sorted(r["coord"] for r in results) == [(a, b) for a in range(lanes)
                                                    for b in range(model)]
    for r in results:
        assert r["lane_group"] == (lanes, r["coord"][0])


def test_each_model_rank_holds_whole_heads(ranks):
    (_, model), results = ranks
    shapes = results[0]["local_shapes"]
    H, Dh = WIDTH["heads"], WIDTH["hidden"]
    assert shapes["a_src"][1] == shapes["a_dst"][1] == H // model
    assert shapes["w_fp"][1] == shapes["b_fp"][0] == shapes["w_g"][0] == H * Dh // model
    assert shapes["w_out"][0] == H * Dh // model and shapes["q"] == (WIDTH["att_dim"],)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_han_agrees_with_one_process(ranks, backend):
    _, results = ranks
    for r in results:
        one_logits, one_loss, one_grads = r[f"one/{backend}"]
        logits, loss, grads = r[f"sharded/{backend}"]
        torch.testing.assert_close(logits, one_logits, rtol=0, atol=REL_TOL *
                                   float(one_logits.abs().max()))
        assert abs(float(loss) - float(one_loss)) <= REL_TOL * abs(float(one_loss))
        for k, g in grads.items():
            w = one_grads[k]
            assert g.shape == w.shape, k
            assert float((g - w).abs().max()) <= REL_TOL * float(w.abs().max()), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_group_ranks_agree_bitwise_and_runs_repeat(ranks, backend):
    (_, model), results = ranks
    first = results[0][f"sharded/{backend}"]
    for r in results:
        logits, loss, grads = r[f"sharded/{backend}"]
        again = r[f"again/{backend}"]
        assert torch.equal(logits, again[0]) and torch.equal(loss, again[1])
        assert all(torch.equal(g, again[2][k]) for k, g in grads.items())
        # every rank gathers the same whole gradients; logits and loss are
        # the model group's (the lane group's all-reduce makes them the mesh's)
        assert torch.equal(logits, first[0]) and torch.equal(loss, first[1])
        assert all(torch.equal(g, first[2][k]) for k, g in grads.items())


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_gradient_norm_of_the_pieces_is_the_whole_gradients(ranks, backend):
    """What AdamW clips by: the same on every rank, and the one-process norm."""
    _, results = ranks
    for r in results:
        norm = r[f"sharded/{backend}/norm"]
        assert torch.equal(norm, results[0][f"sharded/{backend}/norm"])
        whole = torch.sqrt(sum(torch.sum(g * g) for g in r[f"one/{backend}"][2].values()))
        assert abs(float(norm) - float(whole)) <= 1e-6 * float(whole)


def test_run_training_over_the_mesh_lowers_the_loss(ranks):
    (lanes, model), results = ranks
    for r in results:
        assert r["losses"][-1] < r["losses"][0] and r["losses"] == results[0]["losses"]
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
