"""Wrapper the ``h100`` to_integral definition calls (mirrors
``repro/kernels/to_integral/ops.py``): a CUDA tensor launches the CUDA C++
movemask (or raises on what it does not take), a CPU tensor takes the plain
version. ``to_integral.launches`` counts kernel launches.

Nothing is padded: the reference pads the lanes to 128 and the rows to its
block; the kernel reads the rows where they lie (16-byte loads for 32-lane
rows at an aligned base, a warp per row otherwise: ``kernel.body``)."""

from __future__ import annotations

import math

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.bool, torch.uint8)


def to_integral(mask: torch.Tensor) -> torch.Tensor:
    """(..., n <= 32) mask -> (...,) uint32 words, bit i = lane i."""
    if mask.device.type == "cpu":
        return ref.to_integral(mask)
    check_cuda_tensor(mask, "to_integral mask", _DTYPES)
    if mask.ndim == 0 or mask.shape[-1] > 32:
        raise ValueError(f"to_integral: want (..., n <= 32) lanes, got {tuple(mask.shape)}")
    lead, n = mask.shape[:-1], mask.shape[-1]
    m2 = mask.view(math.prod(lead), n)
    out = torch.empty(m2.shape[0], dtype=torch.uint32, device=mask.device)
    if n == 0:
        out.zero_()
    elif m2.shape[0]:
        kernel.to_integral_2d(m2, out)
        to_integral.launches += 1
    return out.view(lead)


to_integral.launches = 0

__all__ = ["to_integral", "ref"]
