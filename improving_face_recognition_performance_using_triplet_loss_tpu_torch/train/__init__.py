"""Training of the triplet head: steps, optimizer, state, checkpoints and
the epoch loop."""

from .checkpoint import Checkpointer  # noqa: F401
from .loops import (  # noqa: F401
    EpochStats, NonFiniteLossError, PreemptionGuard, resume_if_available,
    train_loop,
)
from .optim import get_ema_params, sgd_wd, with_param_ema  # noqa: F401
from .state import TrainState, create_train_state  # noqa: F401
from .steps import (  # noqa: F401
    HEAD_METRIC_KEYS, make_head_eval_step, make_head_train_step,
)
