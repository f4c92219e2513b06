from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .losses import task_loss  # noqa: F401
from .train_step import (  # noqa: F401
    TrainState,
    compute_loss,
    init_train_state,
    make_train_step,
    param_grads,
)
