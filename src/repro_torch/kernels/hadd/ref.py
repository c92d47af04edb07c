"""Plain PyTorch horizontal add (paper Fig 9): the ``torch_cpu`` definition,
and what the Hopper kernel is held against (mirrors
``repro/kernels/hadd/ref.py``)."""

from __future__ import annotations

import torch


def hadd(value: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis: bf16/f16 accumulate in f32 and cast back;
    f32 sums in f32; int32 sums in int32 and wraps, as ``jnp.sum`` does
    (torch would widen an integer sum to int64). A 1-D input gives a 0-d
    result."""
    if value.dtype in (torch.bfloat16, torch.float16):
        return value.sum(-1, dtype=torch.float32).to(value.dtype)
    return value.sum(-1, dtype=value.dtype)
