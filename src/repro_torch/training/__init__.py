"""Training on torch: the pure train step (``make_train_step``), its
state (``TrainState``) and the training loop (``Trainer``)."""
from repro_torch.training.trainer import Trainer, TrainState, make_train_step

__all__ = ["Trainer", "TrainState", "make_train_step"]
