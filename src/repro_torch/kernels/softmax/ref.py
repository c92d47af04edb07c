"""Plain PyTorch row softmax: the ``torch_cpu`` definition, and what the
Triton kernel is held against (mirrors ``repro/kernels/softmax/ref.py``)."""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis: statistics in f32, output in x's
    dtype. A row of only -inf gives NaN, as the reference's does."""
    xf = x.float()
    m = xf.amax(-1, keepdim=True)
    p = torch.exp(xf - m)
    return (p / p.sum(-1, keepdim=True)).to(x.dtype)
