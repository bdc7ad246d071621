from .hgnn import (
    hgnn_loss_and_grads,
    hgnn_param_axes,
    hgnn_train_state_axes,
    init_hgnn_train_state,
    make_hgnn_train_step,
)
from .loop import train_loop
from .step import TrainState, lm_loss, make_train_step, train_state_axes

__all__ = [
    "TrainState",
    "make_train_step",
    "lm_loss",
    "train_state_axes",
    "train_loop",
    "hgnn_loss_and_grads",
    "hgnn_param_axes",
    "hgnn_train_state_axes",
    "init_hgnn_train_state",
    "make_hgnn_train_step",
]
