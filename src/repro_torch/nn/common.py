"""Shared building blocks: init helpers + the norm over TSL primitives.

Parameter trees are built by one description per module that calls
``make(kind, shape, **kw)`` for every leaf (``kw``: ``value``, ``scale``,
``leaf_dtype``, see :func:`init_leaf`): :func:`init_leaf` fills it with
seeded random values, ``lambda kind, shape, **kw: shape`` lists the expected
shapes (which ``nn.model.load_jax_params`` checks the reference's params
against)."""

from __future__ import annotations

import torch


def init_leaf(kind: str, shape: tuple[int, ...], *, dtype: torch.dtype,
              device: torch.device, generator: torch.Generator,
              value: float | None = None, scale: float | None = None,
              leaf_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One parameter leaf, drawn from ``generator`` in f32 and cast to
    ``leaf_dtype`` (default ``dtype``, the model's):

    * ``dense``: truncated normal in [-3, 3] scaled by ``scale``, default
      fan_in ** -0.5 with fan_in the second-to-last dim (the input width;
      leading dims are the stacked layer axis) — the reference's
      ``dense_init``;
    * ``embed``: normal * 0.02; ``ones`` / ``zeros``: norms and biases;
      ``full``: every element ``value``."""
    dtype = leaf_dtype or dtype
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "full":
        return torch.full(shape, float(value), dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "embed":
        t.normal_(0.0, 0.02, generator=generator)
    elif kind == "dense":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
        t.mul_(shape[-2] ** -0.5 if scale is None else scale)
    else:
        raise ValueError(f"unknown init kind {kind!r}")
    return t.to(dtype)


def init_norm(cfg, make, lead=()):
    """rmsnorm: {w}; layernorm: {w, b}, the bias zero."""
    p = {"w": make("ones", (*lead, cfg.d_model))}
    if cfg.norm == "layernorm":
        p["b"] = make("zeros", (*lead, cfg.d_model))
    return p


def apply_norm_params(tsl, cfg, p, x):
    """``cfg.norm`` through TSL: rmsnorm (w) or layernorm (w, b)."""
    if cfg.norm == "rmsnorm":
        return tsl.rmsnorm(x, p["w"], eps=cfg.norm_eps)
    return tsl.layernorm(x, p["w"], p.get("b"), eps=cfg.norm_eps)
