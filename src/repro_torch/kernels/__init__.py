"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it.  Importing this package builds nothing: a kernel is
compiled (``kernels/build.py``) the first time a CUDA tensor reaches it."""
from .flash_attention import flash_attention, flash_attention_plain
from .fused_adamw import fused_adamw, fused_adamw_plain
from .fused_fp_coeff import fused_fp_coeff, fused_fp_coeff_plain
from .seg_gat_agg import seg_gat_agg, seg_gat_agg_plain
from .seg_gat_agg_fused_fp import (
    seg_gat_agg_fused_fp,
    seg_gat_agg_fused_fp_bwd,
    seg_gat_agg_fused_fp_bwd_plain,
    seg_gat_agg_fused_fp_fwd,
    seg_gat_agg_fused_fp_plain,
)
from .seg_gat_agg_multigraph import (
    seg_gat_agg_multigraph,
    seg_gat_agg_multigraph_bwd,
    seg_gat_agg_multigraph_bwd_plain,
    seg_gat_agg_multigraph_fwd,
    seg_gat_agg_multigraph_plain,
)
from .topology import Topology

__all__ = [
    "Topology",
    "flash_attention",
    "flash_attention_plain",
    "fused_adamw",
    "fused_adamw_plain",
    "fused_fp_coeff",
    "fused_fp_coeff_plain",
    "seg_gat_agg",
    "seg_gat_agg_plain",
    "seg_gat_agg_fused_fp",
    "seg_gat_agg_fused_fp_bwd",
    "seg_gat_agg_fused_fp_bwd_plain",
    "seg_gat_agg_fused_fp_fwd",
    "seg_gat_agg_fused_fp_plain",
    "seg_gat_agg_multigraph",
    "seg_gat_agg_multigraph_bwd",
    "seg_gat_agg_multigraph_bwd_plain",
    "seg_gat_agg_multigraph_fwd",
    "seg_gat_agg_multigraph_plain",
]
