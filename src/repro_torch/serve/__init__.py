"""Serving tier of the port: the HGNN engine (stepped slot batching,
similarity admission, the cross-request FP cache) and the LM engine
(prefill and greedy decode against KV caches, and the continuous
batcher over per-slot positions)."""
from .batcher import ContinuousBatcher, Request
from .engine import ServeState, greedy_generate, init_serve_state, make_prefill, make_serve_step
from .fp_cache import FPCache, FPCacheStats
from .hgnn_engine import GraphRequest, HGNNEngine, make_request_mix

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeState",
    "greedy_generate",
    "init_serve_state",
    "make_prefill",
    "make_serve_step",
    "FPCache",
    "FPCacheStats",
    "GraphRequest",
    "HGNNEngine",
    "make_request_mix",
]
