"""The ``h100`` ``expert_ffn``: the three per-expert products as batched
matmuls in the model's dtype (bf16 operands, float32 accumulation on the
card's tensor cores) and the activation through the swiglu kernel over the
(E·C, F) rows, so the mixture-of-experts path runs a ported kernel. The
large products stay ``torch.bmm``: the JAX package computes them outside
any Pallas kernel. On CPU tensors the swiglu wrapper takes its plain
version."""

from __future__ import annotations

import torch

from ..swiglu.ops import swiglu


def expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, act=swiglu) -> torch.Tensor:
    """(E, C, D) dispatched rows -> (E, C, D), in xe's dtype. ``act`` is the
    activation over the (E·C, F) rows: the swiglu kernel's wrapper, or its
    plain version where the kernel is held against it in context."""
    e, c, _ = xe.shape
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    h = act(g.reshape(e * c, -1), u.reshape(e * c, -1))
    return torch.bmm(h.view(e, c, -1), w_down)
