"""Training: the backbone's and the head's steps, the BEGAN-CS step, the
optimizer families and their schedule, state, checkpoints and the epoch
loop, and their data- and class-parallel forms."""

from .checkpoint import Checkpointer  # noqa: F401
from .loops import (  # noqa: F401
    EpochStats, NonFiniteLossError, PreemptionGuard, resume_if_available,
    train_loop,
)
from .optim import (  # noqa: F401
    FAMILIES, OptimizerSpec, adam, adam_factor, backbone_optimizer,
    factor_schedule, get_ema_params, sgd_wd, with_param_ema,
)
from .sharding import ClassShards  # noqa: F401
from .state import TrainState, create_train_state  # noqa: F401
from .steps import (  # noqa: F401
    BACKBONE_METRIC_KEYS, HEAD_METRIC_KEYS, infer_class_parallel_specs,
    make_backbone_eval_step, make_backbone_train_step, make_head_eval_step,
    make_head_train_step, make_scanned_step, shard_map_scanned_step,
    shard_map_scanned_step_2d, shard_map_step, shard_map_step_2d,
)
