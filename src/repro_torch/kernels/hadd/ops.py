"""Wrapper the ``h100`` hadd definition calls (mirrors
``repro/kernels/hadd/ops.py``): a CUDA tensor launches the CUDA C++ adder
tree (or raises on what it does not take), a CPU tensor takes the plain
version. ``hadd.launches`` counts kernel calls (one per call, whether the
kernel runs as one launch or, for split rows, two).

Nothing is padded: the kernel masks the row tail itself."""

from __future__ import annotations

import math

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def hadd(value: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of an arbitrary-rank input (a 1-D input gives
    a 0-d result), in the accumulation of ``ref.hadd``."""
    if value.device.type == "cpu":
        return ref.hadd(value)
    check_cuda_tensor(value, "hadd value", _DTYPES)
    if value.ndim == 0:
        raise ValueError("hadd: expected at least one axis, got a 0-d tensor")
    lead, n = value.shape[:-1], value.shape[-1]
    x2 = value.view(math.prod(lead), n)
    out = torch.empty(x2.shape[0], dtype=value.dtype, device=value.device)
    if n == 0:
        out.zero_()
    elif x2.shape[0]:
        kernel.hadd_2d(x2, out)
        hadd.launches += 1
    return out.view(lead)


hadd.launches = 0

__all__ = ["hadd", "ref"]
