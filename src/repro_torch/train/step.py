"""The train step (mirrors ``repro/train/step.py``): loss, gradients and
one AdamW update, with optional microbatch gradient accumulation and int8
gradient compression.

The step makes each parameter a leaf that requires grad for the loss and its
backward only (``tensor.detach().requires_grad_()``: the caller's tensors
are not touched), takes ``model.loss(..., remat=True)`` and
``torch.autograd.grad``, and hands the grads to the AdamW update. Outside
the step the params never require grad, so serving stays in inference mode.
A mesh is not ported yet (ROADMAP.md, queue 1, item 9) and raises.

A :class:`TrainStep` is host preparation (the schedule's scalars from the
host step count) around :meth:`TrainStep.core`, which takes tensors only:
params, moments, batch and the (3,) schedule scalars in; new params and
moments (or the same, updated in place, for a donated state) and the
metrics out. ``train/graphs.py`` captures the core in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import compression

from . import optimizer as opt_mod
from .optimizer import OptConfig, tree_leaves, tree_map


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    compress_grads: bool = False, mesh=None) -> "TrainStep":
    """Returns train_step(train_state, batch) -> (train_state, metrics).

    train_state = {"params", "opt"}; batch = {"tokens", "labels"} (B,S)
    token ids on the model's device. metrics: loss, ce, aux, grad_norm (0-d
    tensors on the device), lr (a float) and, with ``compress_grads``,
    compress_err (0-d float32).

    With ``microbatches`` k > 1 the batch's leading axis is split into k
    parts (B must divide), each part's grads are summed into float32 zeros
    and divided by k, the loss is the mean of the parts' losses and the
    other metrics are the last part's. So the grads that reach compression
    and AdamW are float32 with k > 1 and the params' dtype with k = 1, as in
    the reference."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}: want >= 1")
    if model.cfg.family != "dense":
        from repro_torch.nn.model import RWKV_TRAIN_TODO    # nn imports train

        raise NotImplementedError(f"{model.cfg.name}: {RWKV_TRAIN_TODO}")
    if mesh is not None:
        raise NotImplementedError("mesh: sharded training is not ported yet "
                                  "(ROADMAP.md, queue 1, item 9: sharded engine)")
    return TrainStep(model, opt_cfg, microbatches, compress_grads)


class TrainStep:
    """The eager, functional train step of :func:`make_train_step`."""

    def __init__(self, model, opt_cfg: OptConfig, microbatches: int, compress_grads: bool):
        self.model = model
        self.opt_cfg = opt_cfg
        self.microbatches = microbatches
        self.compress_grads = compress_grads

    def scalars(self, count: int) -> np.ndarray:
        """The (lr, b1c, b2c) float32 scalars of the update after ``count``."""
        return opt_mod.schedule(self.opt_cfg, count)

    def __call__(self, train_state, batch):
        params, opt_state = train_state["params"], train_state["opt"]
        count = opt_state["count"]
        sched = self.scalars(count)
        device = tree_leaves(params)[0].device
        new_params, moments, metrics = self.core(params, opt_state, batch,
                                                 torch.from_numpy(sched).to(device))
        return ({"params": new_params, "opt": {**moments, "count": count + 1}},
                {**metrics, "lr": float(sched[0])})

    def core(self, params, moments, batch, sched: torch.Tensor, *, donate: bool = False):
        """Tensors in, tensors out: (params, {"m", "v"}, metrics) after one
        step on ``batch`` with the schedule's (3,) float32 ``sched``. With
        ``donate`` the update is written into ``params`` and ``moments``
        (which are returned); without, they are left as they were."""
        loss, metrics, grads = self._grads(params, batch)
        if self.compress_grads:
            grads, cerr = compression.compress_decompress(grads)
            metrics = {**metrics, "compress_err": cerr}
        if donate:
            gnorm = opt_mod.apply_updates_(self.opt_cfg, params, grads, moments, sched)
            new_params, new_moments = params, {"m": moments["m"], "v": moments["v"]}
        else:
            new_params, new_moments, gnorm = opt_mod.update(self.opt_cfg, params, grads,
                                                            moments, sched)
        return new_params, new_moments, {"loss": loss, **metrics, "grad_norm": gnorm}

    def _grads(self, params, batch):
        """(loss, metrics, grads); the microbatch loop is the reference's
        ``lax.scan``, unrolled."""
        k = self.microbatches
        if k == 1:
            return loss_and_grads(self.model, params, batch, remat=True)
        parts = {}
        for name, x in batch.items():
            if x.shape[0] % k:
                raise ValueError(f"batch[{name!r}] has {x.shape[0]} rows: not divisible "
                                 f"into {k} microbatches")
            parts[name] = x.reshape(k, x.shape[0] // k, *x.shape[1:])
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        loss_sum = 0.0
        for i in range(k):
            loss, metrics, grads = loss_and_grads(
                self.model, params, {n: v[i] for n, v in parts.items()}, remat=True)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / k, metrics, tree_map(lambda g: g / k, acc)


def loss_and_grads(model, params, batch, *, remat: bool = True):
    """(loss, metrics, grads): ``model.loss`` on leaves that alias ``params``
    and require grad, and the gradient of every leaf (a leaf the loss does
    not reach raises). All returned tensors are detached."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(live, batch, remat=remat)
        flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
    grads = tree_map(lambda _: next(flat), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def init_train_state(model, opt_cfg: OptConfig, seed: int = 0) -> dict:
    """Fresh {params, opt} state: ``model.init(seed)`` and zero moments
    (int8 moments quantize the zeros, as in the reference)."""
    params = model.init(seed)
    return {"params": params, "opt": opt_mod.init_opt_state(opt_cfg, params)}
