"""Training (mirrors ``repro/train``): AdamW with float32 or int8 moments and
the train step with microbatch gradient accumulation and int8 gradient
compression. A sharded step (``mesh=``) is not ported yet (ROADMAP queue 1,
item 9); asking for it raises."""

from .optimizer import OptConfig, apply_updates, init_opt_state, lr_at
from .step import init_train_state, loss_and_grads, make_train_step

__all__ = ["OptConfig", "apply_updates", "init_opt_state", "init_train_state",
           "loss_and_grads", "lr_at", "make_train_step"]
