from .common import HGNNData, HGNNModel, cross_entropy, glorot, prepare_data
from .han import HAN, han_forward, han_forward_multilane, han_forward_staged, init_han
from .rgat import RGAT, init_rgat, rgat_forward
from .rgcn import RGCN, init_rgcn, rgcn_forward
from .shgn import SHGN, init_shgn, shgn_forward

MODELS: dict[str, HGNNModel] = {m.name: m for m in (HAN, RGCN, RGAT, SHGN)}

__all__ = [
    "HGNNData",
    "HGNNModel",
    "cross_entropy",
    "glorot",
    "prepare_data",
    "HAN",
    "RGCN",
    "RGAT",
    "SHGN",
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
]
