from .common import HGNNData, HGNNModel, cross_entropy, glorot, prepare_data
from .han import HAN, han_forward, init_han

MODELS: dict[str, HGNNModel] = {m.name: m for m in (HAN,)}

__all__ = [
    "HGNNData",
    "HGNNModel",
    "cross_entropy",
    "glorot",
    "prepare_data",
    "HAN",
    "MODELS",
    "han_forward",
    "init_han",
]
