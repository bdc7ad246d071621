from .common import glorot

__all__ = ["glorot"]
