"""Wrapper the ``h100`` rmsnorm definition calls: a CUDA tensor launches the
Triton kernel (or raises on what it does not take), a CPU tensor takes the
plain version. ``rmsnorm.launches`` counts kernel launches."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of an arbitrary-rank input."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps=eps)
    check_cuda_tensor(x, "rmsnorm x", _DTYPES)
    check_cuda_tensor(weight, "rmsnorm weight", _DTYPES)
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} on {weight.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    x2 = x.view(-1, d)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        kernel.rmsnorm_2d(x2, weight, out, eps=eps)
        rmsnorm.launches += 1
    return out.view(x.shape)


rmsnorm.launches = 0

__all__ = ["rmsnorm", "ref"]
