"""Rotary position embedding tables (half-split layout, matches TSL rope_apply)."""

from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """positions: int tensor (...,) -> (cos, sin) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                      exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)
