"""Training: AdamW with the cosine / WSD / constant schedules, and the
train step (loss, gradients, microbatch accumulation) over any family."""
from .optimizer import (  # noqa: F401
    OptConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    make_schedule,
)
from .train import init_training, make_train_step  # noqa: F401
