"""Training (mirrors ``repro/train``): AdamW with float32 moments and the
one-microbatch train step. int8 moments, microbatch accumulation, gradient
compression and sharded steps are not ported yet (ROADMAP queue 1, item 2);
asking for them raises."""

from .optimizer import OptConfig, apply_updates, init_opt_state, lr_at
from .step import init_train_state, loss_and_grads, make_train_step

__all__ = ["OptConfig", "apply_updates", "init_opt_state", "init_train_state",
           "loss_and_grads", "lr_at", "make_train_step"]
