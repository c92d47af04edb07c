"""Wrapper the ``h100`` swiglu definition calls: a CUDA tensor launches the
Triton kernel (or raises on what it does not take), a CPU tensor takes the
plain version. ``swiglu.launches`` counts kernel launches."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if gate.device.type == "cpu":
        return ref.swiglu(gate, up)
    check_cuda_tensor(gate, "swiglu gate", _DTYPES)
    check_cuda_tensor(up, "swiglu up", _DTYPES)
    if up.shape != gate.shape or up.dtype != gate.dtype or up.device != gate.device:
        raise ValueError(f"swiglu: up {tuple(up.shape)} {up.dtype} on {up.device} "
                         f"does not match gate {tuple(gate.shape)} {gate.dtype} "
                         f"on {gate.device}")
    out = torch.empty_like(gate)
    if gate.numel():
        kernel.swiglu_flat(gate, up, out)
        swiglu.launches += 1
    return out


swiglu.launches = 0

__all__ = ["swiglu", "ref"]
