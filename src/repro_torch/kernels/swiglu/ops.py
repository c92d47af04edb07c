"""Wrapper the ``h100`` swiglu definition calls: a CUDA tensor launches the
Triton kernel (or raises on what it does not take), a CPU tensor takes the
plain version. ``swiglu.launches`` counts kernel launches.

The reference has no backward kernel for swiglu (``repro/kernels/swiglu``
has no ``custom_vjp``). So when autograd needs a gradient, the forward on
the card is still the Triton kernel, inside :class:`SwiGLU`, and its
backward is plain torch: autograd through the plain version recomputed from
the saved inputs."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _launch(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
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


class SwiGLU(torch.autograd.Function):
    """Triton forward; backward in plain torch on the saved gate and up."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _launch(gate, up)

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        with torch.enable_grad():
            gd, ud = gate.detach().requires_grad_(), up.detach().requires_grad_()
            return torch.autograd.grad(ref.swiglu(gd, ud), (gd, ud), g)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if gate.device.type == "cpu":
        return ref.swiglu(gate, up)
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        return SwiGLU.apply(gate, up)
    return _launch(gate, up)


swiglu.launches = 0

__all__ = ["SwiGLU", "swiglu", "ref"]
