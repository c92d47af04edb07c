"""AdamW (mirrors ``repro/train/optimizer.py``): global-norm clipping, bias
correction, decoupled weight decay on matrices (leaves of ndim >= 2), the
update in float32 cast back to each parameter's dtype, linear warmup then
cosine decay. Moments are float32; the reference's int8 moments
(``moment_dtype="int8"``) are not ported yet and raise.

Params, grads and moments are nested dicts of tensors (the model's param
tree); ``apply_updates`` is functional, as in the reference: it returns new
params and a new state and leaves its inputs untouched. The step count is a
host int, so the schedule costs no device sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

INT8_MOMENTS_TODO = ("int8 optimizer moments are not ported yet "
                     "(ROADMAP.md, queue 1, item 2: 'Training, the rest')")


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"      # "float32"; "int8" is not ported yet

    def __post_init__(self):
        if self.moment_dtype == "int8":
            raise NotImplementedError(INT8_MOMENTS_TODO)
        if self.moment_dtype != "float32":
            raise ValueError(f"moment_dtype {self.moment_dtype!r}: want 'float32'")


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay at (0-based) ``step``."""
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    prog = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                   0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of nested dicts in key order, paths joined by "/"."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in tree_items(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def init_opt_state(cfg: OptConfig, params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": 0}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf^2), in float32."""
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in tree_leaves(tree)))


def apply_updates(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step. Returns (new_params, new_opt_state, metrics) with
    metrics {"grad_norm": 0-d f32 tensor (before clipping), "lr": float}."""
    count = opt_state["count"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-12), max=1.0)
    lr = lr_at(cfg, opt_state["count"])
    b1c = 1 - cfg.b1 ** count
    b2c = 1 - cfg.b2 ** count

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:                       # decoupled wd on matrices only
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
