"""The train step (mirrors ``repro/train/step.py``): loss, gradients and
one AdamW update, with one microbatch.

The step makes each parameter a leaf that requires grad for the loss and its
backward only (``tensor.detach().requires_grad_()``: the caller's tensors
are not touched), takes ``model.loss(..., remat=True)`` and
``torch.autograd.grad``, and hands the grads to ``apply_updates``. Outside
the step the params never require grad, so serving stays in inference mode.
Microbatch accumulation, gradient compression and a mesh are not ported yet
(ROADMAP.md, queue 1, item 2) and raise.
"""

from __future__ import annotations

import torch

from . import optimizer as opt_mod
from .optimizer import OptConfig, tree_leaves, tree_map

NOT_PORTED = "ROADMAP.md, queue 1, item 2: 'Training, the rest'"


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    compress_grads: bool = False, mesh=None):
    """Returns train_step(train_state, batch) -> (train_state, metrics).

    train_state = {"params", "opt"}; batch = {"tokens", "labels"} (B,S)
    token ids on the model's device. metrics: loss, ce, aux, grad_norm (0-d
    tensors on the device) and lr (a float)."""
    if microbatches != 1:
        raise NotImplementedError(f"microbatches={microbatches}: microbatch gradient "
                                  f"accumulation is not ported yet ({NOT_PORTED})")
    if compress_grads:
        raise NotImplementedError(f"compress_grads: int8 error-feedback gradient "
                                  f"compression is not ported yet ({NOT_PORTED})")
    if mesh is not None:
        raise NotImplementedError("mesh: sharded training is not ported yet "
                                  "(ROADMAP.md, queue 1, item 9: sharded engine)")

    def train_step(train_state, batch):
        params, opt_state = train_state["params"], train_state["opt"]
        loss, metrics, grads = loss_and_grads(model, params, batch, remat=True)
        new_params, new_opt, opt_metrics = opt_mod.apply_updates(opt_cfg, params, grads,
                                                                 opt_state)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **metrics, **opt_metrics})

    return train_step


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
    """Fresh {params, opt} state: ``model.init(seed)`` and zero moments."""
    params = model.init(seed)
    return {"params": params, "opt": opt_mod.init_opt_state(opt_cfg, params)}
