"""Device-facing graph format: block CSR.

The (dst × src) adjacency of a SemanticGraph is cut into B×B blocks; only
non-empty blocks are kept, organized as block rows padded to a fixed
number of blocks per row.  This is the HiHGNN hardware adaptation: the
irregular NA stage is *block-densified* so it runs as masked dense tile
work (see DESIGN.md §2).  The per-row block lists are what the
online-softmax kernels (``kernels/seg_gat_agg_multigraph``,
``kernels/seg_gat_agg_fused_fp``) iterate over.

A copy of ``repro.graphs.formats.to_block_csr``; arrays are identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hetgraph import SemanticGraph


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
