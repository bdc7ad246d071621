from .pipeline import SyntheticHGNNData

__all__ = ["SyntheticHGNNData"]
