"""Plain PyTorch RMSNorm: the ``torch_cpu`` definition, and what the Hopper
kernel is held against (mirrors ``repro/kernels/rmsnorm/ref.py``)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalize the last axis and scale: x / rms(x) * weight.

    Statistics in f32 regardless of input dtype (production LM convention).
    """
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps)
    return (out * weight.float()).to(x.dtype)
