"""repro_torch.train — training loop, metrics, checkpoints."""

from . import checkpoint, metrics
from .loop import TrainResult, make_eval_fn, make_train_step, train_ctr
