"""Wrapper the ``h100`` softmax definition calls (mirrors
``repro/kernels/softmax/ops.py``): a CUDA tensor launches the CUDA C++
kernel (or raises on what it does not take), a CPU tensor takes the plain
version.
``softmax.launches`` counts kernel launches."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis of an arbitrary-rank input."""
    if x.device.type == "cpu":
        return ref.softmax(x)
    check_cuda_tensor(x, "softmax x", _DTYPES)
    if x.ndim == 0:
        raise ValueError("softmax: expected at least one axis, got a 0-d tensor")
    out = torch.empty_like(x)
    if x.numel():
        kernel.softmax_2d(x.view(-1, x.shape[-1]), out.view(-1, x.shape[-1]))
        softmax.launches += 1
    return out


softmax.launches = 0

__all__ = ["softmax", "ref"]
