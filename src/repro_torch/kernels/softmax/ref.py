"""Plain PyTorch row softmax: the ``torch_cpu`` definition, and what the
CUDA C++ kernel is held against (mirrors ``repro/kernels/softmax/ref.py``);
``softmax_split`` is the kernel's cluster arithmetic written plainly."""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis: statistics in f32, output in x's
    dtype. A row of only -inf gives NaN, as the reference's does."""
    xf = x.float()
    m = xf.amax(-1, keepdim=True)
    p = torch.exp(xf - m)
    return (p / p.sum(-1, keepdim=True)).to(x.dtype)


def softmax_split(x: torch.Tensor, chunks) -> torch.Tensor:
    """softmax over the last axis as the wide kernel computes it: each chunk
    [c0, c1) of ``chunks`` (tiling the axis) gets its own float32 (m, l),
    l = sum exp(x - m), a chunk of only -inf (-inf, 0); the row's M is the
    largest m, and L = sum l * exp(m - M) is added in chunk order; the output
    exp(x - M) / L is rounded once to x's dtype. A row of only -inf has M =
    -inf and gives NaN."""
    xf = x.float()
    parts = []
    for c0, c1 in chunks:
        c = xf[..., c0:c1]
        m = c.amax(-1, keepdim=True)
        live = m > float("-inf")
        l = torch.where(live, torch.exp(c - torch.where(live, m, 0.0)).sum(-1, keepdim=True),
                        0.0)
        parts.append((m, l))
    big = torch.stack([m for m, _ in parts]).amax(0)
    total = torch.zeros_like(big)
    for m, l in parts:
        total = total + l * torch.exp(m - big)
    return (torch.exp(xf - big) / total).to(x.dtype)
