"""Shared building blocks: init helpers + the norm over TSL primitives.

Parameter trees are built by one description per module that calls
``make(kind, shape)`` for every leaf: :func:`init_leaf` fills it with seeded
random values, ``lambda kind, shape: shape`` lists the expected shapes (which
``nn.model.load_jax_params`` checks the reference's params against)."""

from __future__ import annotations

import torch


def init_leaf(kind: str, shape: tuple[int, ...], *, dtype: torch.dtype,
              device: torch.device, generator: torch.Generator) -> torch.Tensor:
    """One parameter leaf, drawn from ``generator`` in f32 and cast:

    * ``dense``: truncated normal in [-3, 3] scaled by fan_in ** -0.5, where
      fan_in is the second-to-last dim (the input width; leading dims are the
      stacked layer axis) — the reference's ``dense_init``;
    * ``embed``: normal * 0.02; ``ones`` / ``zeros``: norms and biases."""
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "embed":
        t.normal_(0.0, 0.02, generator=generator)
    elif kind == "dense":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
        t.mul_(shape[-2] ** -0.5)
    else:
        raise ValueError(f"unknown init kind {kind!r}")
    return t.to(dtype)


def init_norm(cfg, make, lead=()):
    return {"w": make("ones", (*lead, cfg.d_model))}


def apply_norm_params(tsl, cfg, p, x):
    """RMSNorm through TSL (every dense config normalizes with rmsnorm)."""
    return tsl.rmsnorm(x, p["w"], eps=cfg.norm_eps)
