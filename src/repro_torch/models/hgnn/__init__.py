from .common import HGNNData, HGNNModel, cross_entropy, glorot, live_relations, prepare_data
from .han import HAN, han_forward, han_forward_multilane, han_forward_staged, init_han
from .rgat import RGAT, init_rgat, rgat_forward
from .rgcn import RGCN, init_rgcn, rgcn_forward
from .shgn import (
    SHGN,
    SIMPLE_HGN,
    init_shgn,
    init_simple_hgn,
    prepare_simple_hgn,
    shgn_forward,
    simple_hgn_forward,
    simple_hgn_graph,
)

MODELS: dict[str, HGNNModel] = {m.name: m for m in (HAN, RGCN, RGAT, SHGN, SIMPLE_HGN)}

__all__ = [
    "HGNNData",
    "HGNNModel",
    "cross_entropy",
    "glorot",
    "live_relations",
    "prepare_data",
    "HAN",
    "RGCN",
    "RGAT",
    "SHGN",
    "SIMPLE_HGN",
    "MODELS",
    "han_forward",
    "han_forward_multilane",
    "han_forward_staged",
    "init_han",
    "init_rgat",
    "rgat_forward",
    "init_rgcn",
    "rgcn_forward",
    "init_shgn",
    "shgn_forward",
    "init_simple_hgn",
    "prepare_simple_hgn",
    "simple_hgn_forward",
    "simple_hgn_graph",
]
