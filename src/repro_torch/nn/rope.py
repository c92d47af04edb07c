"""Rotary position embedding tables (half-split layout, matches TSL rope_apply)."""

from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """positions: int tensor (...,) -> (cos, sin) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a Python base: no host-to-device copy, so a captured step can build it
    freqs = torch.pow(float(theta), exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)
