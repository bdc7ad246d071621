"""AdamW over a whole parameter tree as one kernel pair on the card: the
unfactored update of ``optim.adamw`` with its global-norm clip.

:func:`fused_adamw` is the wrapper.  It takes a tree's leaves as lists in
``tree_leaves`` order (params, grads, the moments ``m`` and ``v``, the
``master`` slots, None where a param keeps none), the step counter
``count`` and ``lr`` (on the card, a float32 tensor of one element).
Leaves on a CUDA device (:func:`on_card`) launch the two kernels of
``csrc/fused_adamw.cu`` for every group of leaves (:func:`plan`): pass 1
writes each chunk's sum of squares of the gradient, pass 2 reduces them
to the norm in a fixed order and updates its chunk; operands the kernels
do not take raise.  CPU leaves take :func:`fused_adamw_plain`, the plain
version: ``optim.adamw``'s per-leaf loop, the oracle the kernels are held
against.

``in_place=True`` writes the step into the tensors given (``count`` too);
``in_place=False`` leaves them as they are and returns fresh tensors, one
a leaf, as ``optim.apply_updates`` promises.  The kernels read the clip
scale's inputs, the bias corrections and ``lr`` on the card: nothing is
copied from the host's pageable memory and nothing waits for the card.

The kernels repeat the loop's arithmetic operation by operation; only the
norm's sum runs in another order (chunks of :func:`plan`, then leaves in
order), so the two agree to float32 rounding, and two runs of the kernels
give the same bits.

Counters: ``fused_adamw.launches`` (two a group a step) and
``fused_adamw.leaves`` (leaves updated by the kernels).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build

_NAME = "fused_adamw"
_DTYPES = (torch.float32, torch.bfloat16)
MAX_LEAVES = 300      # leaves one launch's parameter struct holds (csrc: kMaxLeaves)
MIN_CHUNK = 8192      # elements a block takes at least: 32 a thread
TARGET_SLOTS = 1024   # chunks a tree is cut into at most, over and above one a leaf
_PARAM_BF16, _GRAD_BF16, _MASTER = 1, 2, 4  # a leaf's flags (csrc: struct Leaf)


@dataclasses.dataclass(frozen=True)
class Group:
    """Leaves ``[start, stop)``, launched together: each leaf's first chunk
    counted from the group's, the group's chunks (one block each), and the
    slot of its first chunk among the norm partials of the whole tree."""
    start: int
    stop: int
    first_chunk: tuple[int, ...]
    n_chunks: int
    slot0: int


@dataclasses.dataclass(frozen=True)
class Plan:
    chunk: int                # elements a chunk holds (a leaf's last one fewer)
    groups: tuple[Group, ...]
    n_slots: int              # chunks of all groups: the norm partials


@functools.lru_cache(maxsize=64)
def plan(sizes: tuple[int, ...], max_leaves: int = MAX_LEAVES) -> Plan:
    """The launches for leaves of ``sizes`` elements: groups of at most
    ``max_leaves`` leaves in order, each leaf cut into ``chunk``-element
    chunks (none for an empty leaf).  ``chunk`` grows with the tree so that
    a tree has at most ``TARGET_SLOTS`` chunks plus one a leaf: every block
    of pass 2 reduces all of them."""
    if max_leaves < 1:
        raise ValueError(f"max_leaves must be positive, got {max_leaves}")
    if any(n < 0 for n in sizes):
        raise ValueError(f"negative leaf size in {sizes}")
    chunk = max(MIN_CHUNK, -(-sum(sizes) // TARGET_SLOTS))
    groups, slot = [], 0
    for start in range(0, len(sizes), max_leaves):
        stop = min(start + max_leaves, len(sizes))
        first, k = [], 0
        for n in sizes[start:stop]:
            first.append(k)
            k += -(-n // chunk)
        groups.append(Group(start, stop, tuple(first), k, slot))
        slot += k
    return Plan(chunk, tuple(groups), slot)


def on_card(params) -> bool:
    """Whether a tree's leaves (``params``, in order) lie on a CUDA device:
    the first one's, which every operand has to share."""
    return bool(params) and params[0].device.type == "cuda"


def _refusal(params, grads, m, v, master, count, lr) -> str | None:
    """Why the kernels cannot take these operands, or None when they can:
    every tensor on the first param's device, params, grads and moments
    float32 or bfloat16 (the moments in one dtype), a master float32 or
    None, the state's leaves contiguous, ``count`` an int32 scalar and
    ``lr`` a float32 scalar tensor."""
    dev = params[0].device
    if not all(len(t) == len(params) for t in (grads, m, v, master)):
        return "the lists differ in length"
    mdt = m[0].dtype
    if mdt not in _DTYPES:
        return f"moments in {mdt}: the kernels take float32 or bfloat16"
    for i, (p, g, mi, vi, ma) in enumerate(zip(params, grads, m, v, master)):
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
            return (f"leaf {i}: param {p.dtype}, grad {g.dtype}: the kernels take float32 "
                    "or bfloat16")
        if mi.dtype != mdt or vi.dtype != mdt:
            return f"leaf {i}: moments {mi.dtype}, {vi.dtype}, not the tree's {mdt}"
        if ma is not None and ma.dtype != torch.float32:
            return f"leaf {i}: master in {ma.dtype}, not float32"
        n = p.numel()
        for name, t in (("param", p), ("grad", g), ("m", mi), ("v", vi), ("master", ma)):
            if t is None:
                continue
            if t.device != dev:
                return f"leaf {i}: {name} on {t.device}, the params on {dev}"
            if t.numel() != n:
                return f"leaf {i}: {name} has {t.numel()} elements, the param {n}"
            if name != "grad" and not t.is_contiguous():
                return f"leaf {i}: {name} is not contiguous"
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != dev:
        return f"count: {count.dtype} of {count.numel()} elements on {count.device}"
    if not isinstance(lr, torch.Tensor):
        return f"lr is a {type(lr).__name__}: the kernels read it on the card"
    if lr.dtype != torch.float32 or lr.numel() != 1 or lr.device != dev:
        return f"lr: {lr.dtype} of {lr.numel()} elements on {lr.device}"
    return None


def fused_adamw_plain(cfg, lr, params, grads, m, v, master, count, *, in_place: bool = True):
    """Plain PyTorch version of the kernels: ``optim.adamw``'s global norm,
    then its per-leaf loop a slice at a time.  Returns (params, m, v,
    master, count, grad_norm): the lists given, updated, or with
    ``in_place=False`` updated copies."""
    from ..optim.adamw import global_norm, update_leaves_

    if not in_place:
        params, m, v = ([t.clone() for t in ts] for ts in (params, m, v))
        master = [None if t is None else t.clone() for t in master]
        count = count.clone()
    gnorm = global_norm(grads)
    update_leaves_(cfg, lr, gnorm, params, grads, m, v, master, count)
    return params, m, v, master, count, gnorm


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.fused_adamw_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_adamw_max_leaves.restype = ctypes.c_int
    if lib.fused_adamw_max_leaves() != MAX_LEAVES:
        raise RuntimeError(f"{_NAME}: the library holds {lib.fused_adamw_max_leaves()} leaves "
                           f"a launch, the wrapper plans {MAX_LEAVES}")
    return lib, fn


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _table(group: Group, ins, outs) -> np.ndarray:
    """A group's rows of ``struct Leaf``: twelve int64 words a leaf."""
    rows = []
    for k, i in enumerate(range(group.start, group.stop)):
        p, g, m, v, ma = (x[i] for x in ins)
        po, mo, vo, mao = (x[i] for x in outs)
        flags = ((_PARAM_BF16 if p.dtype == torch.bfloat16 else 0)
                 | (_GRAD_BF16 if g.dtype == torch.bfloat16 else 0)
                 | (_MASTER if ma is not None else 0))
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), _ptr(ma),
                     po.data_ptr(), mo.data_ptr(), vo.data_ptr(), _ptr(mao), p.numel(),
                     group.first_chunk[k], flags))
    return np.array(rows, dtype=np.int64)


def _launch(cfg, lr, params, grads, m, v, master, count, *, in_place: bool):
    """Launch the kernel pairs on operands :func:`_refusal` took, on the
    current stream.  Returns (params, m, v, master, count, grad_norm): the
    tensors given, written in place, or fresh ones, one a leaf.  Counts
    two launches a group."""
    dev = params[0].device
    if in_place:
        outs, count_out = (params, m, v, master), count
    else:
        outs = tuple([None if t is None else torch.empty_like(t) for t in ts]
                     for ts in (params, m, v, master))
        count_out = torch.empty_like(count)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    pl = plan(tuple(p.numel() for p in params))
    slots = max(pl.n_slots, 1)
    scratch = torch.empty(2 * slots, dtype=torch.int32, device=dev)  # float32 sums, int32 opens
    part = scratch.data_ptr()
    opens = part + 4 * slots
    hyper = (ctypes.c_float * 7)(cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                                 cfg.weight_decay, cfg.grad_clip)
    ins = (params, grads, m, v, master)
    tables = [_table(grp, ins, outs) for grp in pl.groups]
    mom_bf16 = int(m[0].dtype == torch.bfloat16)
    lib, fn = _kernel_fn()
    stream = build.stream_of(params[0])
    with torch.cuda.device(dev):
        for pass_ in (0, 1):
            for k, (grp, table) in enumerate(zip(pl.groups, tables)):
                err = fn(pass_, table.ctypes.data, grp.stop - grp.start, grp.n_chunks, pl.chunk,
                         grp.slot0, pl.n_slots, part, opens, count.data_ptr(),
                         count_out.data_ptr(), lr.data_ptr(),
                         ctypes.addressof(hyper), gnorm.data_ptr(), mom_bf16, int(k == 0),
                         stream)
                build.check_error(lib, _NAME, err)
                fused_adamw.launches += 1
    fused_adamw.leaves += len(params)
    return (*outs, count_out, gnorm)


def fused_adamw(cfg, lr, params, grads, m, v, master, count, *, in_place: bool = True):
    """One AdamW step of ``cfg`` (``optim.AdamWConfig``, unfactored) over a
    tree's leaves.  Returns (params, m, v, master, count, grad_norm).

    Leaves on a CUDA device launch the kernels, and operands they do not
    take raise (:func:`_refusal`); other leaves take the plain version."""
    if not on_card(params):
        return fused_adamw_plain(cfg, lr, params, grads, m, v, master, count, in_place=in_place)
    why = _refusal(params, grads, m, v, master, count, lr)
    if why is not None:
        raise TypeError(f"{_NAME}: {why}")
    return _launch(cfg, lr, params, grads, m, v, master, count, in_place=in_place)


fused_adamw.launches = 0
fused_adamw.leaves = 0
