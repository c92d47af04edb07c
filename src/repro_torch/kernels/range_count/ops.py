"""Wrapper the ``h100`` range_count definition calls (mirrors
``repro/kernels/range_count/ops.py``): a CUDA tensor launches the CUDA C++
kernel (or raises on what it does not take), a CPU tensor takes the plain
version. ``range_count.launches`` counts kernel launches.

Unlike the reference wrapper, nothing is padded: the kernel reads the flat
data in place with its runtime length. Each bound keeps the plain version's
promotion (``ref.py``): an integer bound on int32 data compares exactly,
any other bound in float32."""

from __future__ import annotations

import numbers

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.int32)
_INT32 = (-2**31, 2**31 - 1)


def _bound(v, data_dtype: torch.dtype):
    """A bound as the kernel takes it: an int where it compares exactly with
    int32 data, else a float (the launcher rounds it to float32)."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    if data_dtype == torch.int32 and isinstance(v, numbers.Integral):
        if not _INT32[0] <= int(v) <= _INT32[1]:
            raise ValueError(f"range_count: bound {v} out of int32 range for int32 data")
        return int(v)
    return float(v)


def range_count(data: torch.Tensor, low, high) -> torch.Tensor:
    """0-d int32 count of the elements x of ``data`` (any shape) with
    low <= x <= high."""
    if data.device.type == "cpu":
        return ref.range_count(data, low, high)
    check_cuda_tensor(data, "range_count data", _DTYPES)
    out = torch.empty((), dtype=torch.int32, device=data.device)
    lo, hi = _bound(low, data.dtype), _bound(high, data.dtype)
    if data.numel() == 0:
        return out.zero_()
    kernel.range_count_1d(data.view(-1), out, lo=lo, hi=hi)
    range_count.launches += 1
    return out


range_count.launches = 0

__all__ = ["range_count", "ref"]
