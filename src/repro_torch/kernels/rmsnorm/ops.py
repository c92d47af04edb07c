"""Wrapper the ``h100`` rmsnorm definition calls: a CUDA tensor launches the
Triton kernel (or raises on what it does not take), a CPU tensor takes the
plain version. ``rmsnorm.launches`` counts kernel launches.

The reference has no backward kernel for rmsnorm (``repro/kernels/rmsnorm``
has no ``custom_vjp``: JAX differentiates its jnp definition). So when
autograd needs a gradient, the forward on the card is still the Triton
kernel, inside :class:`RMSNorm`, and its backward is plain torch: autograd
through the plain version recomputed from the saved inputs."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
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


class RMSNorm(torch.autograd.Function):
    """Triton forward; backward in plain torch on the saved x and weight."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd, wd = x.detach().requires_grad_(), weight.detach().requires_grad_()
            dx, dw = torch.autograd.grad(ref.rmsnorm(xd, wd, eps=ctx.eps), (xd, wd), g)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of an arbitrary-rank input."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNorm.apply(x, weight, eps)
    return _launch(x, weight, eps)


rmsnorm.launches = 0

__all__ = ["RMSNorm", "rmsnorm", "ref"]
