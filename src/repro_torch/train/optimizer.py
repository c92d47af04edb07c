"""AdamW (mirrors ``repro/train/optimizer.py``): global-norm clipping, bias
correction, decoupled weight decay on matrices (leaves of ndim >= 2), the
update in float32 cast back to each parameter's dtype, linear warmup then
cosine decay. Moments are float32, or int8 with a per-row float32 scale
(``moment_dtype="int8"``): each moment leaf is then a ``{"q", "scale"}``
dict, dequantized before the update and quantized again after it.

Params, grads and moments are nested dicts of tensors (the model's param
tree); ``apply_updates`` is functional, as in the reference: it returns new
params and a new state and leaves its inputs untouched. The step count is a
host int, so the schedule costs no device sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

MOMENT_DTYPES = ("float32", "int8")


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
    moment_dtype: str = "float32"      # "float32" | "int8"

    def __post_init__(self):
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype {self.moment_dtype!r}: want one of "
                             f"{MOMENT_DTYPES}")


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


def is_q(x) -> bool:
    """An int8 moment: one leaf of the params' structure held as q + scale."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def flatten_up_to(structure, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``, in
    ``tree_leaves(structure)`` order: a moment leaf (a tensor, or an int8
    ``{"q", "scale"}`` dict) comes back whole."""
    if isinstance(structure, dict):
        return [x for k, v in structure.items() for x in flatten_up_to(v, tree[k])]
    if not (torch.is_tensor(tree) or is_q(tree)):
        raise TypeError(f"moment leaf of type {type(tree).__name__}: want a tensor or "
                        f"an int8 {{'q', 'scale'}} dict")
    return [tree]


def unflatten(structure, leaves):
    """Inverse of :func:`flatten_up_to`: ``leaves`` placed at the leaves of
    ``structure``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


# -- int8 moment quantization (per-row absmax scaling) ------------------------

def _quantize(x: torch.Tensor) -> dict:
    """Per-row (last-axis) absmax int8: scale = max(amax, 1e-12) / 127 and
    q = clip(round(x / scale), -127, 127), rounding half to even as the
    reference does. The division is kept: a multiply by the reciprocal moves
    q at .5 boundaries."""
    amax = x.abs().amax(-1, keepdim=True) if x.ndim >= 1 else x.abs()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequantize(qs: dict) -> torch.Tensor:
    return qs["q"].float() * qs["scale"]


def init_opt_state(cfg: OptConfig, params) -> dict:
    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.moment_dtype == "int8" else z

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
    quant = cfg.moment_dtype == "int8"

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * (_dequantize(m) if quant else m) + (1 - cfg.b1) * g
        v = cfg.b2 * (_dequantize(v) if quant else v) + (1 - cfg.b2) * g.square()
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:                       # decoupled wd on matrices only
            update = update + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * update).to(p.dtype)
        return new_p, (_quantize(m) if quant else m), (_quantize(v) if quant else v)

    out = [upd(*leaves) for leaves in zip(tree_leaves(params), flatten_up_to(params, grads),
                                          flatten_up_to(params, opt_state["m"]),
                                          flatten_up_to(params, opt_state["v"]))]
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
