"""HGNN serving tier of the port: stepped slot batching, similarity
admission and the cross-request FP cache."""
from .fp_cache import FPCache, FPCacheStats
from .hgnn_engine import GraphRequest, HGNNEngine, make_request_mix

__all__ = ["FPCache", "FPCacheStats", "GraphRequest", "HGNNEngine", "make_request_mix"]
