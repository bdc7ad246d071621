from .pipeline import SyntheticHGNNData, hgnn_minibatches

__all__ = ["SyntheticHGNNData", "hgnn_minibatches"]
