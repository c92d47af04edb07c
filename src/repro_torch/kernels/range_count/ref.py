"""Plain PyTorch range count (paper Fig 8): the ``torch_cpu`` definition, and
what the Hopper kernel is held against (mirrors
``repro/kernels/range_count/ref.py``, the reference's ``cpu_xla``
definition).

The bounds compare under torch's type promotion, as jnp's: int32 data
against int bounds compares exactly, against a float bound in float32 (a
Python float is a weak scalar: ``arange(10, int32)`` in [5.5, 7.9] counts 6
and 7); float32 data compares against the bounds rounded to float32. NaN is
never in range."""

from __future__ import annotations

import torch


def range_count(data: torch.Tensor, low, high) -> torch.Tensor:
    """0-d int32 count of the elements x of ``data`` with low <= x <= high."""
    data = data.reshape(-1)
    mask = (data >= low) & (data <= high)
    return mask.sum(dtype=torch.int32)
