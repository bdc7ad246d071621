"""The checked topology of the edge kernels #1–#5.

The edge kernels read their unit tables unchecked: a bad index reads out
of bounds.  A :class:`Topology` owns the tables of one set of work units,
(``col_index``, ``graph_id``, ``dst_row``, ``masks``), with the padded
extents (G, Ns_pad, Nd_pad) they index and the block B.  It checks their
dtypes, shapes and values once, when it is built (every minimum and
maximum read back in one host copy, :func:`check_ranges`), and keeps the
tensors and their version counters, no copies.  Every edge kernel takes
it as ``topology=``; a call with none builds one from its operands, so a
direct call still refuses out-of-range input.

One rule holds a topology to a call's operands (:meth:`Topology.holds`,
:func:`hold`): the tensors it was built from, unchanged since, pass with
no device read; any other tensor is compared by value, so equal copies
pass and another topology raises, as does a table changed in place after
the check.

What the kernels' passes index is built from the topology on first use
and kept with it: #2's edge lists (:meth:`Topology.edge_index`) and #3/#4's
row tiles and backward CSRs for one ``wsel`` (:meth:`Topology.fused_index`,
on the topology re-blocked to B = 32 above it).  The joint NA's ragged
layout (:func:`joint_index`) goes through the same range check and rule.
"""
from __future__ import annotations

import torch

from .build import check_tensor

EDGE_BLOCKS = (8, 16, 32, 64, 128)  # B that #1, #2 and #5 take (csrc/edge_na.cuh: kMaxBlock)
UNIT_TABLES = ("col_index", "graph_id", "dst_row", "masks")
JOINT_TABLES = ("unit_off", "slot_col", "slot_rel", "masks")  # what joint_index reads


def check_ranges(**bounds) -> None:
    """Raise unless every entry of each ``name=(tensor, lo, hi)`` lies in
    [lo, hi).  Reads the device once for all of them, so it waits for it."""
    items = [(name, t, lo, hi) for name, (t, lo, hi) in bounds.items() if t.numel()]
    if not items:
        return
    ext = torch.stack([torch.stack(torch.aminmax(t)).long() for _, t, _, _ in items]).tolist()
    for (name, _, lo, hi), (vmin, vmax) in zip(items, ext):
        if vmin < lo or vmax >= hi:
            raise ValueError(f"{name}: entries must lie in [{lo}, {hi}), got [{vmin}, {vmax}]")


def hold(what: str, held: dict, given: dict) -> None:
    """The rule: raise unless each ``given[name]`` (None skips it) is what
    ``held[name] = (tensor, version)`` recorded.  The recorded tensor at its
    version passes with no device read; another tensor passes if its values
    are equal.  A recorded tensor changed in place since raises."""
    for name, t in given.items():
        if t is None:
            continue
        ref, version = held[name]
        if ref._version != version:
            raise ValueError(f"the {what}'s {name} changed in place after it was checked")
        if t is ref:
            continue
        if (not isinstance(t, torch.Tensor)
                or (t.dtype, t.shape, t.device) != (ref.dtype, ref.shape, ref.device)
                or not torch.equal(t, ref)):
            raise ValueError(f"the {what} was built for another {name}")


def csr(keys: torch.Tensor, n_keys: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(offsets int32 [n_keys + 1], items int32 [N]): the positions of
    ``keys`` grouped by key, in their own order within a key (a stable
    sort), so a segmented sum over them runs in a fixed order."""
    sorted_keys, order = torch.sort(keys.long(), stable=True)
    bounds = torch.arange(n_keys + 1, device=keys.device)
    return (torch.searchsorted(sorted_keys, bounds).int().contiguous(),
            order.int().contiguous())


class Topology:
    """Work units (graph ``graph_id[u]``, dst-block row ``dst_row[u]``),
    each sweeping its W src blocks ``col_index[u, w]`` (-1 = padding) under
    its B × B ``masks[u, w]``, checked against G graphs of ``ns_pad`` src
    and ``nd_pad`` dst rows: int32 [U, W], [U], [U] and bool [U, W, B, B],
    contiguous, on one device, ``col_index`` in [-1, Ns_pad / B),
    ``graph_id`` in [0, G) and ``dst_row`` in [0, Nd_pad / B).  It keeps
    ``units`` (the four tables), ``extents`` (U, W, B, G, Ns_pad, Nd_pad)
    and ``block``, ``n_graphs``, ``ns_pad``, ``nd_pad``."""

    def __init__(self, col_index, graph_id, dst_row, masks, *, n_graphs: int, ns_pad: int,
                 nd_pad: int):
        dev = getattr(col_index, "device", None)
        check_tensor("col_index", col_index, torch.int32, (None, None), dev)
        U, W = col_index.shape
        check_tensor("masks", masks, torch.bool, (U, W, None, None), dev)
        B = masks.shape[-1]
        check_tensor("masks", masks, torch.bool, (U, W, B, B), dev)
        check_tensor("graph_id", graph_id, torch.int32, (U,), dev)
        check_tensor("dst_row", dst_row, torch.int32, (U,), dev)
        if ns_pad % B or nd_pad % B:
            raise ValueError(f"Ns_pad={ns_pad} and Nd_pad={nd_pad} must be multiples of B={B}")
        check_ranges(col_index=(col_index, -1, ns_pad // B), graph_id=(graph_id, 0, n_graphs),
                     dst_row=(dst_row, 0, nd_pad // B))
        self.units = (col_index, graph_id, dst_row, masks)
        self.block, self.n_graphs, self.ns_pad, self.nd_pad = B, n_graphs, ns_pad, nd_pad
        self.extents = (U, W, B, n_graphs, ns_pad, nd_pad)
        self._held = {k: (t, t._version) for k, t in zip(UNIT_TABLES, self.units)}
        self._edge_index = None
        self._fused = None

    @classmethod
    def one_graph(cls, col_index, masks, *, ns_pad: int) -> "Topology":
        """One graph's block CSR as units: unit r is dst-block row r."""
        R = col_index.shape[0]
        dev = col_index.device
        return cls(col_index, torch.zeros(R, dtype=torch.int32, device=dev),
                   torch.arange(R, dtype=torch.int32, device=dev), masks, n_graphs=1,
                   ns_pad=ns_pad, nd_pad=R * masks.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.units[3].device

    def holds(self, col_index, graph_id, dst_row, masks, *, n_graphs: int, ns_pad: int,
              nd_pad: int) -> "Topology":
        """This topology, after :func:`hold` of the operands' unit tables
        (None skips one: #5 reads no ``graph_id`` or ``dst_row``) and a check
        that their extents are the ones it was checked against."""
        extents = (*col_index.shape, masks.shape[-1], n_graphs, ns_pad, nd_pad)
        if extents != self.extents:
            raise ValueError(f"the topology was built for (U, W, B, G, Ns_pad, Nd_pad) = "
                             f"{self.extents}, the operands have {extents}")
        hold("topology", self._held, dict(zip(UNIT_TABLES, (col_index, graph_id, dst_row, masks))))
        return self

    def edge_index(self) -> dict:
        """#2's edge index (:func:`build_edge_index`), built on first use."""
        if self._edge_index is None:
            self._edge_index = build_edge_index(self)
        return self._edge_index

    def fused_index(self, wsel: torch.Tensor, n_tables: int, *, backward: bool = True) -> dict:
        """#3/#4's index over one table of Ns_pad = Nd_pad rows, for the
        graphs' weight tables ``wsel`` (int32 [G] in [0, ``n_tables``),
        checked once) and the first (``wsel``, ``n_tables``) asked for; a
        later call holds ``wsel`` by the rule:

        * ``units``: the unit tables the kernels read, this topology's own,
          or above B = 32 :func:`~.seg_gat_agg_fused_fp.reblock`'s at 32;
        * ``tiles``: :func:`~.seg_gat_agg_fused_fp.row_tiles` of those;
        * with ``backward`` (built on first use): the live-slot numbering
          and CSRs of :func:`~.seg_gat_agg_fused_fp.bwd_index`."""
        from .seg_gat_agg_fused_fp import KERNEL_BLOCK, bwd_index, reblock, row_tiles

        if self._fused is None:
            if self.block not in EDGE_BLOCKS:
                raise ValueError(f"fused FP+NA: block size B={self.block} not in {EDGE_BLOCKS}")
            if self.ns_pad != self.nd_pad:
                raise ValueError(f"fused FP+NA reads one table of rows: Ns_pad={self.ns_pad} "
                                 f"and Nd_pad={self.nd_pad} must be equal")
            check_tensor("wsel", wsel, torch.int32, (self.n_graphs,), self.device)
            check_ranges(wsel=(wsel, 0, n_tables))
            units = reblock(*self.units) if self.block > KERNEL_BLOCK else self.units
            kb = units[3].shape[-1]
            index = dict(units=units, tiles=row_tiles(*units[:3], wsel, self.ns_pad, kb))
            self._fused = dict(n_tables=n_tables, held=dict(wsel=(wsel, wsel._version)),
                               index=index)
        elif n_tables != self._fused["n_tables"]:
            raise ValueError(f"the topology's fused index was built for "
                             f"{self._fused['n_tables']} weight tables, the call has {n_tables}")
        else:
            hold("topology's fused index", self._fused["held"], dict(wsel=wsel))
        index = self._fused["index"]
        if backward and "pair_of" not in index:
            units, kb = index["units"], index["units"][3].shape[-1]
            index.update(bwd_index(*units[:3], self._fused["held"]["wsel"][0], self.n_graphs,
                                   n_tables, self.ns_pad // kb))
        return index


def build_edge_index(topology: Topology) -> dict:
    """The edge index #2 reads, on the topology's device.  The edges are
    the set mask entries of live slots, numbered dst-major in the forward's
    order, by (unit u, dst row i, slot w, src j):

    * ``row_off`` int32 [U·B + 1]: unit row u·B + i's edges start there;
    * ``e_src`` int32 [E]: each edge's src vertex col[u, w]·B + j;
    * ``src_off`` int32 [Ns_pad·G + 1], ``src_edge`` and ``src_row`` int32
      [E]: the src-major CSR, the edges sorted by (src vertex, graph, unit,
      slot, i), one segment a (src vertex, graph): each edge's dst-major
      number and unit row;
    * ``gdst``: (offsets, units) of each (graph, dst block), in unit order;
    * ``E``.

    Building it takes a device sort and host syncs, once a topology."""
    col_index, graph_id, dst_row, masks = topology.units
    U, _, B, n_graphs, ns_pad, nd_pad = topology.extents
    nblk_d = nd_pad // B
    live = masks & (col_index >= 0)[:, :, None, None]
    u, i, w, j = live.permute(0, 2, 1, 3).nonzero(as_tuple=True)  # dst-major order
    src = col_index.long()[u, w] * B + j
    rows = u * B + i
    row_off = torch.zeros(U * B + 1, dtype=torch.long, device=masks.device)
    row_off[1:] = torch.cumsum(torch.bincount(rows, minlength=U * B), 0)
    src_off, src_edge = csr(src * n_graphs + graph_id.long()[u], ns_pad * n_graphs)
    return dict(
        E=int(src.numel()), row_off=row_off.int(), e_src=src.int(), src_off=src_off,
        src_edge=src_edge, src_row=rows[src_edge.long()].int(),
        gdst=csr(graph_id.long() * nblk_d + dst_row.long(), n_graphs * nblk_d))


def joint_index(unit_off, slot_col, slot_rel, masks, n_units: int, ns_pad: int,
                n_rel: int) -> dict:
    """The joint NA's topology, checked (reads the device), with the edge
    list both directions read: the edges are the set mask entries of units
    [0, n_units), numbered dst-major in the forward's order, by (dst row
    u·B + i, slot, src j):

    * ``row_off`` int32 [n_units·B + 1], ``e_row``, ``e_src``, ``e_rel`` int32 [E];
    * ``src_off`` int32 [ns_pad·R + 1], ``src_edge`` and ``src_row`` int32
      [E]: the src-major CSR, a segment a (src vertex, relation), the edges
      in dst-major order within it.

    It holds the topology's tensors too, so a call cannot pair an index
    with another topology, and ``held``, what :func:`hold` holds them to:
    each tensor and its version counter.  Built once per topology (a
    device sort and host syncs)."""
    dev = masks.device
    check_tensor("unit_off", unit_off, torch.int32, (None,), dev)
    check_tensor("slot_col", slot_col, torch.int32, (None,), dev)
    S = slot_col.shape[0]
    check_tensor("slot_rel", slot_rel, torch.int32, (S,), dev)
    check_tensor("masks", masks, torch.bool, (S, None, None), dev)
    B = masks.shape[-1]
    if B not in EDGE_BLOCKS or masks.shape[1] != B or ns_pad % B:
        raise ValueError(f"joint NA: B={B} must be in {EDGE_BLOCKS} and divide ns_pad={ns_pad}")
    if not 0 <= n_units < unit_off.shape[0]:
        raise ValueError(f"joint NA: n_units={n_units} of {unit_off.shape[0] - 1} units")
    off = unit_off[: n_units + 1].long()
    check_ranges(slot_col=(slot_col, 0, ns_pad // B), slot_rel=(slot_rel, 0, n_rel),
                 **{"unit_off[0]": (off[:1], 0, 1), "unit_off's steps": (off.diff(), 0, S + 1),
                    f"unit_off[{n_units}]": (off[-1:], 0, S + 1)})
    slot_unit = torch.repeat_interleave(torch.arange(n_units, device=dev), off[1:] - off[:-1])
    s, i, j = masks[: int(off[-1])].nonzero(as_tuple=True)  # (slot, i, j) order
    rows, order = torch.sort(slot_unit[s] * B + i, stable=True)  # then by dst row
    s, j = s[order], j[order]
    e_src = slot_col.long()[s] * B + j
    e_rel = slot_rel.long()[s]
    row_off = torch.zeros(n_units * B + 1, dtype=torch.long, device=dev)
    row_off[1:] = torch.cumsum(torch.bincount(rows, minlength=n_units * B), 0)
    src_off, src_edge = csr(e_src * n_rel + e_rel, ns_pad * n_rel)
    return dict(
        U=n_units, B=B, ns_pad=ns_pad, R=n_rel, E=int(e_src.numel()),
        unit_off=unit_off, slot_col=slot_col, slot_rel=slot_rel, masks=masks,
        held={k: (t, t._version) for k, t in zip(JOINT_TABLES, (unit_off, slot_col, slot_rel,
                                                               masks))},
        row_off=row_off.int(), e_row=rows.int(), e_src=e_src.int(), e_rel=e_rel.int(),
        src_off=src_off, src_edge=src_edge, src_row=rows[src_edge.long()].int())


def resolve(topology: Topology | None, col_index, graph_id, dst_row, masks, *, n_graphs: int,
            ns_pad: int, nd_pad: int) -> Topology:
    """``topology`` held to these operands (:meth:`Topology.holds`), or,
    when None, one built from them (which checks their values; without
    ``graph_id`` and ``dst_row``: :meth:`Topology.one_graph`)."""
    if topology is None and graph_id is None:
        return Topology.one_graph(col_index, masks, ns_pad=ns_pad)
    if topology is None:
        return Topology(col_index, graph_id, dst_row, masks, n_graphs=n_graphs, ns_pad=ns_pad,
                        nd_pad=nd_pad)
    if not isinstance(topology, Topology):
        raise TypeError(f"topology: expected a Topology, got {type(topology).__name__}")
    return topology.holds(col_index, graph_id, dst_row, masks, n_graphs=n_graphs, ns_pad=ns_pad,
                          nd_pad=nd_pad)
