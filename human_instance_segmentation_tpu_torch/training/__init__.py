"""Training: state, optimizer, steps, checkpoints and the loop."""

from .state import TrainState
from .steps import make_eval_step, make_loss_fn, make_train_step, rois_from_boxes

__all__ = ["TrainState", "make_train_step", "make_eval_step", "make_loss_fn",
           "rois_from_boxes"]
