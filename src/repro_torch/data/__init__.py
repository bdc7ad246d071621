from .pipeline import SyntheticHGNNData, SyntheticLMData, hgnn_minibatches

__all__ = ["SyntheticHGNNData", "SyntheticLMData", "hgnn_minibatches"]
