"""The compiled train step: the port's counterpart of
``jax.jit(train_step, donate_argnums=(0,))`` (``repro/launch/train.py:107``),
on the shared machinery of ``repro_torch/graphs.py``.

``compile_train_step(make_train_step(...))`` returns a callable with the
train step's signature. Its first call adopts the train state it is given:
the state is donated, its tensors become the step's own buffers and are
updated in place from then on (the returned state is that same state, its
host count advanced), so no param or moment is copied in or out per step.
On the card that first call runs one real step on a side stream (the
warm-up: Triton compiles, cuBLAS loads, autograd's stream bookkeeping
settles) and captures :meth:`TrainStep.core` (forward, autograd backward,
the unrolled microbatches, compression and the in-place AdamW update) on
that stream into one CUDA graph; every later call stages the batch (pinned,
``non_blocking``) and the schedule's (lr, b1c, b2c) scalars from the host
count into static buffers, replays, and advances the count. Forward and
backward are captured on one stream, so autograd's backward lands on it.

The metrics are static 0-d tensors, valid until the next call (``lr`` is a
host float). After the first call the step takes only the state it returned:
any other (one restored from a checkpoint, say) raises, and goes to a fresh
compiled step instead. A batch of other names, shapes or dtypes than the
first raises. A capture or replay
that fails raises; nothing falls back to eager. Under
``repro_torch.graphs.disable_graphs()`` the call is the eager, functional
train step on the caller's tensors, op by op. On the CPU the same object
runs the core eagerly on its static buffers and the donated state, so the
staging, the donation and the scalars are the card's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.graphs import CudaGraphRunner, Step, _torch_dtype, graphs_enabled

from .step import TrainStep


def _body(train_step: TrainStep, sched, params, moments, **batch) -> dict:
    # a function of the train step, not a method of the compiled step: the
    # Step holding it then makes no reference cycle, and the graph and its
    # pool are freed with the compiled step
    return train_step.core(params, moments, batch, sched, donate=True)[2]


class CompiledTrainStep:
    """``train_step`` compiled over a donated state: captured in a CUDA graph
    on the card, its core run eagerly on the static buffers on the CPU."""

    def __init__(self, train_step: TrainStep):
        self.train_step = train_step
        self.device = torch.device(train_step.model.device)
        # the warm-up's activations go back to the device before the capture,
        # so the pool does not hold a second copy beside the cache
        self.runner = (CudaGraphRunner(self.device, release_cache=True)
                       if self.device.type == "cuda" else None)
        self.step: Step | None = None
        self.state: dict | None = None
        self.batch_specs: dict = {}

    @property
    def entries(self) -> int:
        """Compiled entries: 1 once the step is compiled (captured, on the card)."""
        return 0 if self.step is None else self.step.entries

    def __call__(self, train_state: dict, batch: dict):
        if not graphs_enabled():
            return self.train_step(train_state, {
                k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=self.device)
                for k, v in batch.items()})
        specs = {k: (tuple(v.shape), _torch_dtype(v)) for k, v in batch.items()}
        if self.step is None:
            self._adopt(train_state, batch, specs)
        else:
            if specs != self.batch_specs:
                raise ValueError(f"train batch {specs}: the step was compiled for "
                                 f"{self.batch_specs}")
            if train_state is not self.state:
                raise ValueError("the compiled train step takes only the state it "
                                 "returned; compile a fresh step for another state")
        count = self.state["opt"]["count"]
        sched = self.train_step.scalars(count)
        metrics = self.step(**batch, sched=sched)
        self.state["opt"]["count"] = count + 1
        return self.state, {**metrics, "lr": float(sched[0])}

    def _adopt(self, train_state: dict, batch: dict, specs: dict) -> None:
        opt = train_state["opt"]
        self.state = {"params": train_state["params"],
                      "opt": {"m": opt["m"], "v": opt["v"], "count": opt["count"]}}
        self.batch_specs = specs
        self.step = Step(functools.partial(_body, self.train_step),
                         {**batch, "sched": np.zeros(3, np.float32)},
                         device=self.device, runner=self.runner,
                         donated={"params": self.state["params"],
                                  "moments": {"m": opt["m"], "v": opt["v"]}})


def compile_train_step(train_step: TrainStep) -> CompiledTrainStep:
    """The counterpart of ``jax.jit(train_step, donate_argnums=(0,))``."""
    if not isinstance(train_step, TrainStep):
        raise TypeError(f"compile_train_step takes make_train_step's step, not "
                        f"{type(train_step).__name__}")
    return CompiledTrainStep(train_step)


__all__ = ["CompiledTrainStep", "compile_train_step"]
