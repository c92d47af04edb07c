"""Training (mirrors ``repro/train``): AdamW with float32 or int8 moments,
the train step with microbatch gradient accumulation and int8 gradient
compression, and the step compiled over a donated state (``graphs``: one
CUDA graph on the card, the counterpart of ``jax.jit(train_step,
donate_argnums=(0,))``). A sharded step (``mesh=``) is not ported yet
(ROADMAP queue 1, item 9); asking for it raises."""

from .graphs import CompiledTrainStep, compile_train_step
from .optimizer import OptConfig, apply_updates, init_opt_state, lr_at
from .step import TrainStep, init_train_state, loss_and_grads, make_train_step

__all__ = ["CompiledTrainStep", "OptConfig", "TrainStep", "apply_updates",
           "compile_train_step", "init_opt_state", "init_train_state", "loss_and_grads",
           "lr_at", "make_train_step"]
