"""Training (port of the JAX package's ``train/``): the optimizer and freeze
masks, the train and eval steps, checkpoints and the epoch loop."""

from .optimizer import cosine_annealing_schedule, make_optimizer, phase_trainable_mask
from .step import KDModels, TrainState, make_eval_step, make_loss_fn, make_train_step

__all__ = [
    "KDModels",
    "TrainState",
    "cosine_annealing_schedule",
    "make_eval_step",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
    "phase_trainable_mask",
]
