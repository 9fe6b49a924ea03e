"""repro_torch.core — CowClip, the scaling rules and the optimizer algebra."""

from .builders import (
    TRAIN_PATHS,
    TrainStepBundle,
    build_optimizer,
    build_train_step,
    dense_tower_tx,
    label_params,
    two_group,
)
from .cowclip import (
    cowclip,
    cowclip_rows,
    cowclip_table,
    clip_table_global,
    clip_table_columnwise_const,
    clip_table_fieldwise_adaptive,
    make_clip_transform,
)
from .optim import (
    GradientTransformation,
    adam,
    add_decayed_weights,
    apply_updates,
    chain,
    clip_by_global_norm,
    decay_catchup_rows,
    global_norm,
    identity,
    partition,
    scale,
    scale_by_adam,
    scale_by_neg_lr,
    scale_by_schedule,
    sgd,
    sparse_adam_rows,
)
from .scaling import RULES, Hyperparams, scale_hyperparams
from . import schedules
