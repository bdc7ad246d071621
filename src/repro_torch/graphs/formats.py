"""Device-facing graph formats.

Two executable layouts for a SemanticGraph:

* ``PaddedEdges`` — dst-sorted edge list padded to a static length; drives
  the plain segment ops (the SEGMENT backend, R-GCN's mean NA).  Its
  segments (the edges of one dst vertex) are contiguous.

* ``BlockCSR`` — the (dst × src) adjacency cut into B×B blocks; only
  non-empty blocks are kept, organized as block rows padded to a fixed
  number of blocks per row.  This is the HiHGNN hardware adaptation: the
  irregular NA stage is *block-densified* so it runs as masked dense tile
  work (see DESIGN.md §2).  The per-row block lists are what the
  online-softmax kernels (``kernels/seg_gat_agg``,
  ``kernels/seg_gat_agg_multigraph``, ``kernels/seg_gat_agg_fused_fp``)
  iterate over.

Copies of ``repro.graphs.formats``; arrays are identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hetgraph import SemanticGraph


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedEdges:
    """dst-sorted edge list, padded to ``length`` with sentinel edges.

    Padding edges point at (src=0, dst=num_dst-1), after every real edge,
    so the list stays dst-sorted; ``valid`` masks them out of every
    aggregation.
    """

    src: np.ndarray  # int32 [E_pad]
    dst: np.ndarray  # int32 [E_pad]
    valid: np.ndarray  # bool [E_pad]
    num_src: int
    num_dst: int

    @property
    def num_edges(self) -> int:
        return int(self.valid.sum())


def to_padded_edges(sg: SemanticGraph, *, pad_to: int | None = None) -> PaddedEdges:
    order = np.argsort(sg.dst_ids, kind="stable")
    src = sg.src_ids[order]
    dst = sg.dst_ids[order]
    e = src.shape[0]
    e_pad = pad_to if pad_to is not None else max(_ceil_to(max(e, 1), 128), 128)
    if e_pad < e:
        raise ValueError(f"pad_to={e_pad} is less than the {e} edges")
    pad = e_pad - e
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.full(pad, max(sg.num_dst - 1, 0), np.int32)])
    valid = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])
    return PaddedEdges(src=src, dst=dst, valid=valid, num_src=sg.num_src, num_dst=sg.num_dst)


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """Block-sparse adjacency: non-empty B×B blocks, padded per block row.

    ``col_index[i, j]`` is the src-block column of the j-th kept block in
    dst-block row i, or ``-1`` for padding (its mask slot is all-False).
    ``masks[i, j]`` is the dense B×B boolean adjacency of that block
    (mask[p, q] == edge (src = col*B + q  ->  dst = row*B + p)).
    """

    block: int
    num_dst_pad: int
    num_src_pad: int
    col_index: np.ndarray  # int32 [n_dst_blocks, max_blocks_per_row]
    masks: np.ndarray  # bool  [n_dst_blocks, max_blocks_per_row, B, B]
    num_edges: int

    @property
    def n_dst_blocks(self) -> int:
        return int(self.col_index.shape[0])

    @property
    def max_blocks_per_row(self) -> int:
        return int(self.col_index.shape[1])

    def density(self) -> float:
        """Fraction of kept block slots that are real (non-padding)."""
        return float((self.col_index >= 0).mean())


def to_block_csr(sg: SemanticGraph, *, block: int = 128, min_blocks_per_row: int = 1) -> BlockCSR:
    b = block
    nd_pad = _ceil_to(max(sg.num_dst, 1), b)
    ns_pad = _ceil_to(max(sg.num_src, 1), b)
    n_rows = nd_pad // b

    if sg.num_edges == 0:
        col_index = np.full((n_rows, min_blocks_per_row), -1, np.int32)
        masks = np.zeros((n_rows, min_blocks_per_row, b, b), bool)
        return BlockCSR(b, nd_pad, ns_pad, col_index, masks, 0)

    row_blk = sg.dst_ids // b
    col_blk = sg.src_ids // b
    key = row_blk.astype(np.int64) * (ns_pad // b) + col_blk
    uniq, inv = np.unique(key, return_inverse=True)
    u_rows = (uniq // (ns_pad // b)).astype(np.int32)
    u_cols = (uniq % (ns_pad // b)).astype(np.int32)

    blocks_per_row = np.bincount(u_rows, minlength=n_rows)
    width = max(int(blocks_per_row.max()), min_blocks_per_row)

    col_index = np.full((n_rows, width), -1, np.int32)
    masks = np.zeros((n_rows, width, b, b), bool)
    slot_of_block = np.empty(uniq.shape[0], np.int32)
    cursor = np.zeros(n_rows, np.int32)
    for k in range(uniq.shape[0]):
        r = u_rows[k]
        s = cursor[r]
        cursor[r] += 1
        col_index[r, s] = u_cols[k]
        slot_of_block[k] = s
    # scatter edges into their block masks
    masks[row_blk, slot_of_block[inv], sg.dst_ids % b, sg.src_ids % b] = True
    return BlockCSR(b, nd_pad, ns_pad, col_index, masks, sg.num_edges)


def block_csr_to_dense(bc: BlockCSR) -> np.ndarray:
    """Dense [num_dst_pad, num_src_pad] boolean adjacency (test oracle)."""
    b = bc.block
    out = np.zeros((bc.num_dst_pad, bc.num_src_pad), bool)
    for r in range(bc.n_dst_blocks):
        for j in range(bc.max_blocks_per_row):
            c = bc.col_index[r, j]
            if c >= 0:
                out[r * b : (r + 1) * b, c * b : (c + 1) * b] |= bc.masks[r, j]
    return out


def dense_adjacency(sg: SemanticGraph) -> np.ndarray:
    out = np.zeros((sg.num_dst, sg.num_src), bool)
    out[sg.dst_ids, sg.src_ids] = True
    return out
