"""Production-scale dry run of the LM cells, the counterpart of
``repro.launch.dryrun``: the train, prefill and decode steps of every
architecture laid out on the production mesh under the ``tp`` rules.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out artifacts/dryrun

It needs no card.  Each cell brings up a ``fake`` process group of the
production mesh's 256 ranks (512 with ``--multi-pod``;
``launch.mesh.make_production_mesh``) and, under ``FakeTensorMode``, runs
rank 0's program on fake CPU tensors of the real shapes and dtypes, which
hold no data, as ``launch.hgnn_dryrun`` does: the parameters from
``layers.abstract_from_specs``, cut to rank 0's pieces by
``dist.param_shardings(mesh, make_rules(fsdp=cfg.fsdp, ...), axes)``, and
the cell's inputs (``input_specs``):

* ``train``: ``make_train_step`` with the mesh and the placements, its
  microbatches from ``pick_microbatches`` halved until each splits over
  ``data``, the optimizer from ``opt_config``;
* ``prefill``: the forward of rank 0's rows, its logits split by vocab;
* ``decode``: one ``make_serve_step`` against caches of ``seq_len - 1``
  filled slots, laid out by the reference's heuristic
  (:func:`cache_placements`: the batch over ``data`` where it divides, a
  cache length over ``model``: sequence-sharded KV; the encoder-decoder's
  cross K/V whole on every model rank).

Where the reference reads XLA's ``memory_analysis`` and ``cost_analysis``
of the compiled program, the port reads what the eager run shows:
``MemTracker``'s peak over the call beside the bytes of rank 0's state and
inputs, and ``launch.opstats.analyze``'s product FLOPs and collective
bytes (ROADMAP Queue 3).  Every count is per device and shape-only: CPU
counts of fake tensors, not card times.  The rooflines divide them by the
H100 figures ``launch.hgnn_dryrun`` states.  Each cell's JSON names the
route of its attention layers (``models.lm.attention.attention_route``).

Kept from the reference: ``opt_config``, ``pick_microbatches``,
``input_specs``, ``model_flops``, ``cell_supported`` (``configs``), the
flags, the cached-cell skip and the per-cell JSON.  ``--seq-shard`` sets
the rules' sequence-sharded activations, which only the reference's
activation constraints read: the port's program is the same with it.
A failed cell records the traceback, and the run exits non-zero, as the
reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, Shape, cell_supported, get_config
from ..dist.sharding import (
    Rules,
    _spec_placements,
    local_slice,
    make_rules,
    map_placements,
    param_shardings,
)
from ..models.lm import encdec, transformer
from ..models.lm.api import LMApi, build
from ..models.lm.attention import AttnCache, attention_route
from ..models.lm.config import LMConfig
from ..models.lm.layers import abstract_from_specs
from ..optim import AdamWConfig, init_opt_state
from ..serve.engine import ServeState, init_serve_state, make_serve_step
from ..train.step import TrainState, data_group, make_train_step, train_state_axes
from .hgnn_dryrun import CARD, LINK_BYTES_S, NODE_CARDS, PEAK_FLOPS, PEAK_HBM_BYTES
from .mesh import make_production_mesh
from .opstats import analyze


def opt_config(cfg: LMConfig) -> AdamWConfig:
    """The reference's: above 50 B parameters the factored second moment
    and no float32 master (DESIGN.md §7), else the default AdamW."""
    if cfg.param_count() > 5e10:
        return AdamWConfig(factored=True, master_fp32=False)
    return AdamWConfig()


def pick_microbatches(cfg: LMConfig, default: int | None = None) -> int:
    """None -> the heuristic (16 above 50 B parameters, else 8); an
    explicit value is kept."""
    if default is None:
        return 16 if cfg.param_count() > 5e10 else 8
    return default


def input_specs(cfg: LMConfig, shape: Shape, device="meta") -> dict:
    """Stand-ins for every model input of the cell: empty tensors of their
    global shapes and dtypes on ``device`` (fake ones under a
    ``FakeTensorMode`` with a real device)."""
    b, s = shape.global_batch, shape.seq_len

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":  # one new token against a cache of seq_len
        return {"tokens": empty((b, 1), torch.int32)}
    batch = {"tokens": empty((b, s + 1) if shape.kind == "train" else (b, s), torch.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = empty((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision":
        batch["visual_embeds"] = empty((b, 256, cfg.d_model), torch.bfloat16)
        batch["positions"] = empty((b, s, 3), torch.int32)
    return batch


def cache_spec(dims: tuple[int, ...], *, batch: int, lens: tuple[int, ...],
               data_axes: tuple[str, ...] | None, sizes: dict) -> tuple:
    """The reference's ``_dim_heuristic_spec`` for one cache-like tensor:
    the first dim equal to the batch (dividing over the data axes, and
    more than 1) rides the data axes, the first dim equal to a cache
    length and a multiple of the ``model`` ranks (16 on the production
    mesh) rides ``model`` (sequence-sharded KV), the rest replicate."""
    data_sz = math.prod(sizes[a] for a in data_axes) if data_axes else 1
    used_data = used_model = False
    parts = []
    for d in dims:
        if not used_data and data_axes and d == batch and d % data_sz == 0 and d > 1:
            parts.append(tuple(data_axes) if len(data_axes) > 1 else data_axes[0])
            used_data = True
        elif not used_model and d in lens and d % sizes["model"] == 0:
            parts.append("model")
            used_model = True
        else:
            parts.append(None)
    return tuple(parts)


def cache_placements(mesh, caches, cfg: LMConfig, *, batch: int, cache_len: int,
                     data_axes: tuple[str, ...] | None):
    """Placements of a cache tree on ``mesh`` by :func:`cache_spec` (the
    reference's ``serve_state_shardings`` of the caches): one tuple a
    tensor, in the tree's structure (``AttnCache`` and recurrent tuples
    kept)."""
    lens = (cache_len,) if not cfg.window else (cache_len, min(cache_len, cfg.window))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def place(t):
        return _spec_placements(mesh, cache_spec(tuple(t.shape), batch=batch, lens=lens,
                                                 data_axes=data_axes, sizes=sizes))

    def walk(c):
        if isinstance(c, AttnCache):
            return AttnCache(*(place(t) for t in (c.k, c.v, c.pos)))
        if isinstance(c, dict):
            return {k: walk(v) for k, v in c.items()}
        if isinstance(c, list):
            return [walk(v) for v in c]
        if isinstance(c, tuple):
            return tuple(place(t) for t in c)
        return place(c)

    return walk(caches)


def model_flops(cfg: LMConfig, shape: Shape) -> float:
    """Analytic MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _nbytes(tree) -> int:
    from ..tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _rows(t: torch.Tensor, ranks: int, rank: int) -> torch.Tensor:
    k = t.shape[0] // ranks
    return t[rank * k:(rank + 1) * k]


def _cell_program(api: LMApi, cfg: LMConfig, shape: Shape, mesh, rules: Rules, *,
                  microbatches: int, data_size: int, batch_shard: bool, grad_dtype,
                  data_axes: tuple[str, ...]):
    """(program, the bytes of rank 0's state and inputs, extra result
    fields): rank 0's call of the cell on fake tensors."""
    def cut(placements, tree):  # rank 0's pieces
        return map_placements(lambda p, x: local_slice(x, p, mesh), placements, tree)

    specs = (encdec.encdec_specs(cfg) if cfg.is_encoder_decoder
             else transformer.decoder_specs(cfg))
    params = abstract_from_specs(specs, cfg.param_dtype, device="cpu")
    batch = input_specs(cfg, shape, device="cpu")
    if shape.kind == "train":
        opt = opt_config(cfg)
        state = TrainState(params=params, opt=init_opt_state(params, opt),
                           step=torch.zeros((), dtype=torch.int32))
        pl = param_shardings(mesh, rules, train_state_axes(api, opt, params))
        state = cut(pl, state)
        step = make_train_step(api, opt, microbatches=microbatches, mesh=mesh, placements=pl,
                               grad_dtype=grad_dtype)
        return (lambda: step(state, batch)), _nbytes(state) + _nbytes(batch) // data_size, \
            {"microbatches": microbatches}
    pl = param_shardings(mesh, rules, api.axes())
    params = cut(pl, params)
    ranks = data_size if batch_shard else 1
    batch = {k: _rows(v, ranks, 0) for k, v in batch.items()}
    toks = batch.pop("tokens")
    if shape.kind == "prefill":
        def prefill():
            return api.forward(params, toks, mesh=mesh, placements=pl, split_logits=True,
                               **batch)[0]

        return prefill, _nbytes(params) + _nbytes(batch) + _nbytes(toks), {}
    b, s = shape.global_batch, shape.seq_len
    state = init_serve_state(api, b, s, dtype=torch.bfloat16, filled=s - 1, device="cpu")
    place = functools.partial(cache_placements, mesh, cfg=cfg, batch=b, cache_len=s,
                              data_axes=data_axes if batch_shard else None)
    cpl = place(state.caches)
    cross = None if state.cross_kv is None else cut(place(state.cross_kv), state.cross_kv)
    state = ServeState(caches=cut(cpl, state.caches), cache_pos=state.cache_pos, cross_kv=cross)
    step = make_serve_step(api, mesh=mesh, placements=pl, cache_placements=cpl)
    return (lambda: step(params, state, toks)), \
        _nbytes(params) + _nbytes(state.caches) + _nbytes(toks), {}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatches: int | None = None, seq_shard: bool = False, remat: str | None = None,
             parallelism: str = "tp", grad_dtype: str | None = None,
             layers: int | None = None) -> dict:
    """One cell's result (the reference's ``lower_cell``): status ``ok`` with
    rank 0's counts, ``skipped`` (``cell_supported``) or ``failed`` with
    the traceback.  ``layers`` cuts the depth (tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = SHAPES[shape_name]
    result: dict = {
        "arch": arch, "shape": shape_name, "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "kind": shape.kind, "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
    }
    if layers is not None:
        result["layers"] = layers
    ok, why = cell_supported(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    if dist.is_initialized():
        raise RuntimeError("the dry run brings up its own fake process group; one is "
                           "initialised already")
    chips = 512 if multi_pod else 256
    data_size = 32 if multi_pod else 16
    data_axes = ("pod", "data") if multi_pod else ("data",)
    batch_shard = shape.global_batch % data_size == 0 and shape.global_batch >= data_size
    rules = make_rules(multi_pod=multi_pod, fsdp=cfg.fsdp, seq_shard=seq_shard,
                       batch_shard=batch_shard, parallelism=parallelism)
    result["parallelism"] = parallelism
    api = build(cfg)
    mb = 1
    if shape.kind == "train":
        mb = pick_microbatches(cfg, microbatches)
        while shape.global_batch % mb or (shape.global_batch // mb) % data_size:
            mb //= 2  # keep each microbatch shardable over data
        mb = max(mb, 1)
    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        data_group(mesh)  # multi-pod: flattens ("pod", "data") from the mesh's real rank table
        if any(p in transformer.ATTENTION for p in cfg.block_pattern):
            result["attention_route"] = attention_route(cfg, mesh.size(mesh.ndim - 1))
        with FakeTensorMode():
            program, arg_bytes, extra = _cell_program(
                api, cfg, shape, mesh, rules, microbatches=mb, data_size=data_size,
                batch_shard=batch_shard, grad_dtype=grad_dtype, data_axes=data_axes)
            tracker = MemTracker()
            with tracker:
                stats = analyze(program)
            peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    except Exception as e:  # a failure here is a bug in the system, or a layout not ported yet
        result.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        return result
    finally:
        dist.destroy_process_group()
    mf = model_flops(cfg, shape)
    flops = stats.dot_flops
    coll = stats.total_collective_bytes
    result.update(
        extra,
        status="ok",
        run_s=round(time.time() - t0, 2),
        memory=dict(argument_bytes=arg_bytes, peak_bytes=peak,
                    per_device_total=arg_bytes + peak),
        op_stats=dict(dot_flops_per_device=flops, collective_bytes=stats.collective_bytes,
                      collective_count=stats.collective_count),
        model_flops=mf,
        chips=chips,
        roofline=dict(
            card=CARD,
            compute_s=flops / PEAK_FLOPS,
            memory_s_floor=arg_bytes / PEAK_HBM_BYTES,  # rank 0's state and inputs read once
            collective_s=coll / LINK_BYTES_S,
            model_flops_utilization=mf / max(flops * chips, 1.0),
        ),
    )
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    print(f"[dryrun] shape-only counts of rank 0's program on fake tensors, not card times; "
          f"rooflines for {CARD}: {PEAK_FLOPS:.3g} FLOP/s bf16, {PEAK_HBM_BYTES:.3g} B/s HBM, "
          f"{LINK_BYTES_S:.3g} B/s a link direction (a 16-rank axis spans "
          f"{16 // NODE_CARDS} {NODE_CARDS}-card nodes: collective_s is a lower bound)")
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2x16x16' if mp else 'pod16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-cached] {tag}")
                        continue
                t0 = time.time()
                res = run_cell(arch, shape, multi_pod=mp, microbatches=args.microbatches,
                               seq_shard=args.seq_shard)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                if status == "failed":
                    n_fail += 1
                    print(f"[FAIL] {tag}: {res['error']}")
                else:
                    extra = ""
                    if status == "ok":
                        gb = res["memory"]["per_device_total"] / 2**30
                        extra = (f" mem/dev={gb:.2f}GiB route={res.get('attention_route', '-')}"
                                 f" mfu={res['roofline']['model_flops_utilization']:.3f}")
                    print(f"[{status}] {tag}{extra} ({time.time() - t0:.1f}s)")
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
