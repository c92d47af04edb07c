"""Plain PyTorch SwiGLU: the ``torch_cpu`` definition, and what the Hopper
kernel is held against (mirrors ``repro/kernels/swiglu/ref.py``)."""

from __future__ import annotations

import torch


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, computed in f32 and cast back."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)
