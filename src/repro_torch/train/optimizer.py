"""AdamW (mirrors ``repro/train/optimizer.py``): global-norm clipping, bias
correction, decoupled weight decay on matrices (leaves of ndim >= 2), the
update in float32 cast back to each parameter's dtype, linear warmup then
cosine decay. Moments are float32, or int8 with a per-row float32 scale
(``moment_dtype="int8"``): each moment leaf is then a ``{"q", "scale"}``
dict, dequantized before the update and quantized again after it.

Params, grads and moments are nested dicts of tensors (the model's param
tree); ``apply_updates`` is functional, as in the reference: it returns new
params and a new state and leaves its inputs untouched. ``apply_updates_``
is the same update written into the params' and moments' own tensors, for a
donated state (``train/graphs.py``). The step count is a host int; the
schedule's scalars (lr and the two bias corrections) are computed from it on
the host in float32, as the reference computes them, and enter the update as
one (3,) float32 device tensor, so a captured update reads them from a
staged buffer. The update divides by the bias corrections on the device
(true division, as the reference), and both forms share that arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def schedule(cfg: OptConfig, count: int) -> np.ndarray:
    """(lr, b1c, b2c) of the update that follows ``count`` updates, in
    float32 as the reference computes them: linear warmup + cosine decay at
    (0-based) step ``count``, and the bias corrections 1 - b ** (count + 1)."""
    f32 = np.float32
    step = f32(count)
    warm = np.minimum(f32(1), (step + f32(1)) / f32(max(cfg.warmup_steps, 1)))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)), f32(0), f32(1))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
    scale = f32(cfg.min_lr_ratio) + f32(1 - cfg.min_lr_ratio) * cos
    lr = f32(cfg.lr) * warm * scale
    n = f32(count + 1)
    return np.array([lr, f32(1) - f32(cfg.b1) ** n, f32(1) - f32(cfg.b2) ** n], np.float32)


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay at (0-based) ``step``."""
    return float(schedule(cfg, step)[0])


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


def _leaf_update(cfg: OptConfig, p, g, m, v, clip, sched):
    """One leaf's AdamW update: (new param in p's dtype, m, v in float32)."""
    quant = cfg.moment_dtype == "int8"
    lr, b1c, b2c = sched[0], sched[1], sched[2]
    g = g.float() * clip
    m = cfg.b1 * (_dequantize(m) if quant else m) + (1 - cfg.b1) * g
    v = cfg.b2 * (_dequantize(v) if quant else v) + (1 - cfg.b2) * g.square()
    update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if p.ndim >= 2:                       # decoupled wd on matrices only
        update = update + cfg.weight_decay * p.float()
    return (p.float() - lr * update).to(p.dtype), m, v


def _clip(cfg: OptConfig, grads) -> tuple[torch.Tensor, torch.Tensor]:
    """(global norm of ``grads`` before clipping, the factor that clips it)."""
    gnorm = _global_norm(grads)
    return gnorm, torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-12), max=1.0)


def _leaves(params, grads, moments) -> list:
    return list(zip(tree_leaves(params), flatten_up_to(params, grads),
                    flatten_up_to(params, moments["m"]),
                    flatten_up_to(params, moments["v"])))


def update(cfg: OptConfig, params, grads, moments: dict, sched: torch.Tensor):
    """The functional update with the schedule's (3,) device scalars:
    (new_params, {"m", "v"}, grad_norm)."""
    gnorm, clip = _clip(cfg, grads)
    store = _quantize if cfg.moment_dtype == "int8" else (lambda x: x)
    out = []
    for leaves in _leaves(params, grads, moments):
        new_p, m, v = _leaf_update(cfg, *leaves, clip, sched)
        out.append((new_p, store(m), store(v)))
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, {"m": new_m, "v": new_v}, gnorm


def apply_updates_(cfg: OptConfig, params, grads, moments: dict,
                   sched: torch.Tensor) -> torch.Tensor:
    """:func:`update` written into each param's and moment's own tensor (a
    donated state: nothing is allocated that outlives one leaf's update).
    Returns grad_norm."""
    gnorm, clip = _clip(cfg, grads)
    for p, g, m, v in _leaves(params, grads, moments):
        new_p, new_m, new_v = _leaf_update(cfg, p, g, m, v, clip, sched)
        p.copy_(new_p)
        for dst, src in ((m, new_m), (v, new_v)):
            if is_q(dst):
                q = _quantize(src)
                dst["q"].copy_(q["q"])
                dst["scale"].copy_(q["scale"])
            else:
                dst.copy_(src)
    return gnorm


def apply_updates(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step. Returns (new_params, new_opt_state, metrics) with
    metrics {"grad_norm": 0-d f32 tensor (before clipping), "lr": float}."""
    count = opt_state["count"]
    sched = schedule(cfg, count)
    device = tree_leaves(params)[0].device
    new_p, moments, gnorm = update(cfg, params, grads, opt_state,
                                   torch.from_numpy(sched).to(device))
    return new_p, {**moments, "count": count + 1}, \
        {"grad_norm": gnorm, "lr": float(sched[0])}
