"""Training on torch: the pure train step (``make_train_step``) and its
state (``TrainState``)."""
from repro_torch.training.trainer import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step"]
