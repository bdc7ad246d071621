"""Logical-axis sharding rules, the counterpart of ``repro.dist.sharding``.

Model code never names a mesh dimension.  Parameter trees carry *logical*
axes (``("embed", "mlp")`` for HAN's ``w_fp``), and a :class:`Rules`
table, built for a launch posture by :func:`make_rules`, translates them
to a spec over the named dimensions of a ``torch.distributed`` device
mesh (``launch.mesh.make_mesh``).  The postures are the reference's:

* ``"tp"``: data-parallel batch × tensor-parallel weights; ``fsdp=True``
  also shards the ``embed`` dim of every weight over the data axes,
  ``seq_shard=True`` sequence-shards activations over ``model``;
* ``"sp"``: sequence parallelism, weights model-replicated;
* ``"serve2d"``: decode, weights resident (``embed`` over ``data``,
  ``mlp``/``heads`` over ``model``), the batch not sharded;
* ``"lanes"``: the paper's multi-lane execution (HiHGNN §4.2): work units
  ride the ``lane`` dimension, head and feature dims ride ``model``.

Compounding and conflicts, as the reference pins them: multi-pod
compounds the data (and lane) axes, ``("pod", "data")``, which appears as
one tuple entry of the spec; within one spec each mesh axis is used at
most once (a later logical axis whose mesh axes are taken maps to None);
``batch_shard=False`` gates ``act_batch`` off.

JAX places a leaf by a ``NamedSharding``; eager PyTorch holds each rank's
piece explicitly.  :func:`param_shardings` gives, per leaf, one
``torch.distributed.tensor`` placement per mesh dimension (``Shard(dim)``
or ``Replicate()``); :func:`local_slice` takes a rank's piece of a logical
leaf and :func:`gather_leaf` rebuilds the logical leaf from the pieces,
with the rank's slice of the cotangent as its backward.

The LM under the ``model`` axis (the ``tp`` posture) computes on its
pieces with explicit collectives, each an autograd function whose
backward is stated: :func:`sum_partials` (a row-parallel product's partial
sums, all-reduced; backward the identity), :func:`gather_columns` (an
activation's column blocks, all-gathered, where each rank then uses the
whole differently; backward a reduce-scatter) and :func:`gather_fsdp`
(a leaf's pieces over the data axes, the same reduce-scatter backward:
each data rank saw other rows).  :class:`ModelSplit` holds a rank's place
on the ``model`` axis for the modules.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist
from torch.distributed.tensor import Placement, Replicate, Shard

# Logical parameter axes that ride the tensor-parallel `model` mesh axis
# under the "tp" posture.  Everything not named in a table replicates.
_MODEL_PARAM_AXES = (
    "heads",
    "kv_heads",
    "mlp",
    "vocab",
    "experts",
    "ssm_inner",
    "rnn",
)

# Activation counterparts (the `act_` namespace keeps activation layout
# decisions independent of weight layout: serve2d shards one without the
# other).
_MODEL_ACT_AXES = ("act_heads", "act_mlp", "act_vocab", "act_experts")

Spec = tuple  # one entry a tensor dim: a mesh axis name, a tuple of them, or None


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical-axis → mesh-axes table with spec translation.

    ``table`` maps a logical axis name to a tuple of mesh axis names
    (compound axes allowed, e.g. ``("pod", "data")``) or None for
    replicated.  Unknown names are replicated."""

    table: dict[str, tuple[str, ...] | None]
    name: str = "tp"

    def spec(self, axes: tuple[str | None, ...]) -> Spec:
        """Translate a logical-axes tuple into a spec, the entries of the
        reference's ``PartitionSpec``: a mesh axis name, a tuple of names
        (a compound axis) or None.  Each mesh axis is used at most once:
        later logical axes whose mesh axes were taken collapse to None."""
        used: set[str] = set()
        parts: list[str | tuple[str, ...] | None] = []
        for name in axes:
            mesh_axes = self.table.get(name) if name is not None else None
            if not mesh_axes:
                parts.append(None)
                continue
            fresh = tuple(a for a in mesh_axes if a not in used)
            used.update(fresh)
            if not fresh:
                parts.append(None)
            elif len(fresh) == 1:
                parts.append(fresh[0])
            else:
                parts.append(fresh)
        return tuple(parts)

    def mesh_axes(self, name: str) -> tuple[str, ...] | None:
        """Mesh axes backing one logical axis (None = replicated)."""
        return self.table.get(name)


def make_rules(
    *,
    multi_pod: bool = False,
    fsdp: bool = False,
    seq_shard: bool = False,
    batch_shard: bool = True,
    parallelism: str = "tp",
) -> Rules:
    """Build the Rules for one launch posture (see the module docstring)."""
    data: tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    model: tuple[str, ...] = ("model",)
    lane: tuple[str, ...] = ("pod", "lane") if multi_pod else ("lane",)

    table: dict[str, tuple[str, ...] | None]
    if parallelism == "tp":
        table = {
            "act_batch": data if batch_shard else None,
            "act_seq": model if seq_shard else None,
            "act_qseq": model if seq_shard else None,
            "act_embed": None,
            "embed": data if fsdp else None,
            "layers": None,
        }
        table.update({a: model for a in _MODEL_PARAM_AXES})
        table.update({a: model for a in _MODEL_ACT_AXES})
    elif parallelism == "sp":
        table = {
            "act_batch": data if batch_shard else None,
            "act_seq": model,
            "act_qseq": model,
            "act_embed": None,
            "embed": data if fsdp else None,
            "layers": None,
        }
        table.update({a: None for a in _MODEL_PARAM_AXES})
        table.update({a: None for a in _MODEL_ACT_AXES})
    elif parallelism == "serve2d":
        table = {
            "act_batch": None,
            "act_seq": None,
            "act_qseq": None,
            "act_embed": data,
            "embed": data,
            "layers": None,
        }
        table.update({a: model for a in _MODEL_PARAM_AXES})
        table.update({a: model for a in _MODEL_ACT_AXES})
    elif parallelism == "lanes":
        # (semantic graph, dst block row) units ride `lane`; head/feature
        # dims ride `model`; vertex-space tensors replicate (every lane reads
        # the whole projected table).  A lane mesh has no `data` axis.
        table = {
            "lane": lane,
            "act_lane": lane,
            "act_vertex": None,
            "act_graph": None,
            "act_feat": model,
            "act_batch": None,
            "embed": None,
            "layers": None,
        }
        table.update({a: model for a in _MODEL_PARAM_AXES})
        table.update({a: model for a in _MODEL_ACT_AXES})
    else:
        raise ValueError(f"unknown parallelism {parallelism!r}")
    return Rules(table=table, name=parallelism)


# Active-rules context: thread-local, so that rules never leak across threads.
_state = threading.local()


def active_rules() -> Rules | None:
    """The innermost ``use_rules`` Rules, or None outside any context."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Install ``rules`` as the ambient sharding rules for the block.  Nests:
    the innermost rules win, and the previous ones are restored on exit,
    also on an exception."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


# The data group of the running train step: a process-wide slot, not a
# thread-local one, because the backward (and remat's recompute of the
# forward inside it) runs on autograd's own device threads.
_data_group: list = []


def active_data_group():
    """The process group of the innermost :func:`use_data_group`, or None."""
    return _data_group[-1] if _data_group else None


@contextlib.contextmanager
def use_data_group(group):
    """Make ``group`` (a data mesh dimension's) the data group of the block:
    :func:`mean_over_data` averages over it.  The LM step sets it around
    each rank's microbatches, as :func:`use_rules` sets the rules; with
    ``group`` None (one process), or outside it, nothing is reduced."""
    _data_group.append(group)
    try:
        yield group
    finally:
        _data_group.pop()


class _DataMean(torch.autograd.Function):
    """The mean of a statistic over the data group (an all-reduce SUM ÷ n).
    Its backward passes the cotangent on unchanged: every rank computes the
    same function of the mean, and the step's gradient all-reduce already
    divides the ranks' sum by n, so the mean's own 1/n would count twice."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the active data group (:func:`use_data_group`; a
    collective: every rank of the group calls it), for a statistic that the
    reference takes over the whole microbatch, whose rows the group's ranks
    share equally (the MoE balance loss's ``me`` and ``ce``).  ``x`` itself
    outside a data group."""
    group = active_data_group()
    if group is None:
        return x
    return _DataMean.apply(x, group)


def shard(x, *axes: str | None):
    """The reference's layout annotation: returns ``x`` unchanged, in every
    context.  JAX turns it into a sharding constraint inside a rules and
    mesh context; eager PyTorch has no such constraint, and the port holds
    each rank's piece explicitly (:func:`local_slice`, :func:`gather_leaf`),
    so there is nothing here to constrain or check."""
    return x


def lane_axes(rules: Rules) -> tuple[str, ...]:
    """The mesh axes backing the logical ``lane`` axis under ``rules``
    (``("pod", "lane")`` under a multi-pod posture)."""
    axes = rules.mesh_axes("lane")
    if not axes:
        raise ValueError(f"rules {rules.name!r} do not map a lane axis")
    return axes


def is_axes_leaf(a) -> bool:
    """A logical-axes leaf: a tuple of axis names or None (``()`` for a scalar)."""
    return isinstance(a, tuple) and all(isinstance(x, (str, type(None))) for x in a)


def _is_placements(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(p, Placement) for p in a)


def _map(fn, tree, rest, is_leaf):
    """``fn(leaf, *entries)`` over the leaves of ``tree`` (``is_leaf``) and
    the entries of ``rest`` at the same keys; None stays None."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name),
                                          [getattr(r, f.name) for r in rest], is_leaf)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, [r[k] for r in rest], is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, [r[i] for r in rest], is_leaf) for i, v in enumerate(tree))
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def _leaves(tree, is_leaf) -> list:
    """The leaves in ``repro_torch.tree``'s order (dict keys sorted)."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        kids = [tree[k] for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = list(tree)
    else:
        raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")
    return [leaf for k in kids for leaf in _leaves(k, is_leaf)]


def _spec_placements(mesh, spec: Spec) -> tuple[Placement, ...]:
    """One placement per dimension of ``mesh``: ``Shard(i)`` where entry i
    of ``spec`` names that dimension (alone or in a compound), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def map_axes(fn, axes, *trees):
    """``fn(axes_leaf, *entries)`` over the leaves of a logical-axes tree
    and the entries of ``trees`` (of the same structure) at the same keys;
    None stays None."""
    return _map(fn, axes, list(trees), is_axes_leaf)


def param_shardings(mesh, rules: Rules, axes):
    """Map a logical-axes tree (``train.hgnn.hgnn_train_state_axes``: one
    tuple of logical names a tensor dim, ``()`` for scalars, None for an
    absent slot) to per-leaf placements on ``mesh``
    (:func:`_spec_placements` of the leaf's ``rules.spec``)."""
    return map_axes(lambda a: _spec_placements(mesh, rules.spec(a)), axes)


def map_placements(fn, placement_tree, *trees):
    """``fn(placements, *leaves)`` over a placements tree
    (:func:`param_shardings`) and trees of the same structure."""
    return _map(fn, placement_tree, list(trees), _is_placements)


def placement_leaves(placement_tree) -> list[tuple[Placement, ...]]:
    """A placements tree's leaves, in the order of ``tree.tree_leaves`` of
    the state it places."""
    return _leaves(placement_tree, _is_placements)


def _sharded_dims(placement: tuple[Placement, ...], mesh):
    """(mesh dim, tensor dim) of each mesh dimension of more than one rank
    that shards the leaf, in mesh order."""
    return [(d, p.dim) for d, p in enumerate(placement)
            if isinstance(p, Shard) and mesh.size(d) > 1]


def local_slice(x: torch.Tensor, placement: tuple[Placement, ...], mesh) -> torch.Tensor:
    """This rank's piece of the logical leaf ``x``: along each mesh
    dimension that shards it, the contiguous block of its tensor dim at
    the rank's coordinate, in mesh order (so a compound axis splits
    major-first, as JAX's).  Raises unless the mesh dimension divides
    the tensor dim.  ``x`` itself where nothing shards it."""
    for d, dim in _sharded_dims(placement, mesh):
        n = mesh.size(d)
        if x.shape[dim] % n:
            raise ValueError(f"a leaf of shape {tuple(x.shape)} does not split over the "
                             f"{n} ranks of mesh dimension {mesh.mesh_dim_names[d]!r} "
                             f"(tensor dim {dim})")
        chunk = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(d) * chunk, chunk).clone(
            memory_format=torch.contiguous_format)
    return x


class _Gather(torch.autograd.Function):
    """All-gathers the pieces of a leaf over the mesh dimensions that shard
    it, last dimension first (the inverse of :func:`local_slice`).  The
    backward takes the rank's slice of the cotangent: what follows the
    gather runs replicated, so every rank holds the same whole cotangent,
    and a reduce-scatter of it would scale the gradient by the ranks."""

    @staticmethod
    def forward(ctx, x, placement, mesh):
        ctx.placement, ctx.mesh = placement, mesh
        for d, dim in reversed(_sharded_dims(placement, mesh)):
            x = x.contiguous()  # NCCL takes contiguous tensors
            parts = [torch.empty_like(x) for _ in range(mesh.size(d))]
            dist.all_gather(parts, x, group=mesh.get_group(d))
            x = torch.cat(parts, dim=dim)
        return x

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.placement, ctx.mesh), None, None


class _SumCotangent(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the ranks of one
    mesh dimension.  It stands before a product that each rank computes on
    its own piece of a sharded weight: every rank's cotangent is then the
    part of the whole one that its piece saw.  The parts are all-gathered
    and summed in rank order, so every rank holds the same bits."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()  # NCCL takes contiguous tensors
        parts = [torch.empty_like(grad) for _ in range(ctx.mesh.size(ctx.dim))]
        dist.all_gather(parts, grad, group=ctx.mesh.get_group(ctx.dim))
        return torch.stack(parts).sum(dim=0), None, None


def sum_cotangent(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, as the input of a product over this rank's piece of a weight
    sharded on mesh dimension ``axis`` (a collective in the backward: every
    rank of that dimension calls it).  Its gradient is the sum of the
    ranks' parts (:class:`_SumCotangent`).  ``x`` itself where ``axis`` has
    one rank or ``x`` needs no gradient."""
    dim = mesh.mesh_dim_names.index(axis)
    if mesh.size(dim) == 1 or not x.requires_grad:
        return x
    return _SumCotangent.apply(x, mesh, dim)


def gather_leaf(x: torch.Tensor, placement: tuple[Placement, ...], mesh) -> torch.Tensor:
    """The logical leaf of this rank's piece ``x`` (a collective: every rank
    of the mesh calls it), differentiable: its backward is the rank's slice
    of the cotangent (:class:`_Gather`).  ``x`` itself where nothing shards
    it."""
    if not _sharded_dims(placement, mesh):
        return x
    return _Gather.apply(x, placement, mesh)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()  # NCCL takes contiguous tensors
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))  # the ranks' pieces along dim 0
    dist.all_gather_into_tensor(out, x, group=group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    blocks = x.chunk(n, dim=dim)
    parts = torch.cat(blocks) if dim else x.contiguous()  # rank i's block i-th along dim 0
    out = parts.new_empty(blocks[0].shape)
    dist.reduce_scatter_tensor(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherScatter(torch.autograd.Function):
    """All-gathers ``x`` along the (mesh dim, tensor dim) ``pairs``, last
    pair first (the inverse of :func:`local_slice`); the backward
    reduce-scatters the cotangent, first pair first: each rank gets the sum
    over the group's ranks of its own slice.  That is the gradient where
    each rank's use of the whole differs (other rows of the batch, other
    heads), unlike :class:`_Gather`'s."""

    @staticmethod
    def forward(ctx, x, mesh, pairs):
        ctx.mesh, ctx.pairs = mesh, pairs
        for d, dim in reversed(pairs):
            x = _all_gather(x, dim, mesh.get_group(d), mesh.size(d))
        return x

    @staticmethod
    def backward(ctx, grad):
        for d, dim in ctx.pairs:
            grad = _reduce_scatter(grad, dim, ctx.mesh.get_group(d), ctx.mesh.size(d))
        return grad, None, None


class _SumPartials(torch.autograd.Function):
    """All-reduce SUM over one mesh dimension (every rank gets the same
    bits); the backward is the identity: every rank computes the same
    function of the sum, so each partial's cotangent is the sum's."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_partials(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over the ranks of mesh dimension ``axis`` of each rank's
    partial ``x`` (a row-parallel product over this rank's rows of a
    weight), the same on every rank (a collective)."""
    dim = mesh.mesh_dim_names.index(axis)
    if mesh.size(dim) == 1:
        return x
    return _SumPartials.apply(x, mesh.get_group(dim))


def gather_columns(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole of an activation whose tensor dim ``dim`` the ranks of
    mesh dimension ``axis`` hold in contiguous blocks (a column-parallel
    product's output), for a use that differs on each rank (the rank's own
    heads, its own block of the output): the backward is a reduce-scatter
    (:class:`_GatherScatter`)."""
    d = mesh.mesh_dim_names.index(axis)
    if mesh.size(d) == 1:
        return x
    return _GatherScatter.apply(x, mesh, ((d, dim % x.dim()),))


def gather_fsdp(x: torch.Tensor, placement: tuple[Placement, ...], mesh) -> torch.Tensor:
    """This rank's piece of a leaf, gathered over the mesh dimensions other
    than ``model`` that shard it (``fsdp``: ``embed`` over the data axes),
    so that only its ``model`` split is left; the backward reduce-scatters
    the cotangent over them (:class:`_GatherScatter`): the leaf's grad
    piece is then already summed over the data ranks.  ``x`` itself where
    no such dimension shards it."""
    pairs = tuple((d, dim) for d, dim in _sharded_dims(placement, mesh)
                  if mesh.mesh_dim_names[d] != "model")
    if not pairs:
        return x
    return _GatherScatter.apply(x, mesh, pairs)


def data_sharded(placement: tuple[Placement, ...], mesh) -> bool:
    """Whether a mesh dimension other than ``model`` of more than one rank
    shards the leaf (its grad is summed over data by :func:`gather_fsdp`'s
    backward)."""
    return any(mesh.mesh_dim_names[d] != "model" for d, _ in _sharded_dims(placement, mesh))


def _on_dim(mesh, axis: str, dim: int) -> tuple[Placement, ...]:
    return tuple(Shard(dim) if n == axis else Replicate() for n in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """A rank's place on the ``model`` dimension of ``mesh``: ``size``
    ranks, this one at ``rank``.  A module given one computes on its pieces
    of the weights (contiguous blocks of their ``model``-split dims) and
    joins them with the collectives below."""

    mesh: object
    size: int
    rank: int

    def block(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's contiguous block of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} model ranks")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_partials(x, self.mesh, "model")

    def cotangent(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the input of a product over this rank's columns of a
        weight: its gradient sums the ranks' parts (:func:`sum_cotangent`)."""
        return sum_cotangent(x, self.mesh, "model")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks (no gradient)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.mesh.get_group("model"))
        return out

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:func:`gather_columns` over ``model`` (each rank then uses the
        whole its own way)."""
        return gather_columns(x, self.mesh, "model", dim)

    def gather_replicated(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole of ``x``'s blocks for a use that every rank repeats
        alike (:func:`gather_leaf`: the backward takes the rank's slice)."""
        return gather_leaf(x, _on_dim(self.mesh, "model", dim % x.dim()), self.mesh)


def model_split(mesh) -> ModelSplit | None:
    """The :class:`ModelSplit` of ``mesh``'s ``model`` dimension, or None
    where there is no mesh, no such dimension or it holds one rank (the
    one-process path of every module)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    d = mesh.mesh_dim_names.index("model")
    if mesh.size(d) == 1:
        return None
    return ModelSplit(mesh=mesh, size=mesh.size(d), rank=mesh.get_local_rank(d))
