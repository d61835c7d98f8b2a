"""Training: the backbone's and the head's steps, the optimizer
families and their schedule, state, checkpoints and the epoch loop."""

from .checkpoint import Checkpointer  # noqa: F401
from .loops import (  # noqa: F401
    EpochStats, NonFiniteLossError, PreemptionGuard, resume_if_available,
    train_loop,
)
from .optim import (  # noqa: F401
    FAMILIES, OptimizerSpec, adam_factor, backbone_optimizer,
    factor_schedule, get_ema_params, sgd_wd, with_param_ema,
)
from .state import TrainState, create_train_state  # noqa: F401
from .steps import (  # noqa: F401
    BACKBONE_METRIC_KEYS, HEAD_METRIC_KEYS, make_backbone_eval_step,
    make_backbone_train_step, make_head_eval_step, make_head_train_step,
    make_scanned_step,
)
