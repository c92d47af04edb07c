"""Plain PyTorch to_integral / movemask (paper Fig 3/6): the ``torch_cpu``
definition, and what the Hopper kernel is held against (mirrors
``repro/kernels/to_integral/ref.py``); plus the 32-bit popcount the
pack-and-popcount range count needs (torch has no popcount op).

torch's uint32 supports few operations, so both build their words in int64
and convert at the end."""

from __future__ import annotations

import torch


def to_integral(mask: torch.Tensor) -> torch.Tensor:
    """(..., n <= 32) mask -> (...,) uint32 words, bit i = lane i (a nonzero
    lane is set)."""
    n = mask.shape[-1]
    if n > 32:
        raise ValueError(f"to_integral: a word holds 32 lanes, got {n}")
    shifts = torch.arange(n, dtype=torch.int64, device=mask.device)
    words = ((mask != 0).to(torch.int64) << shifts).sum(-1)
    return words.to(torch.uint32)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (uint32 or int32), as int64: the SWAR
    bit count (pairs, nibbles, bytes, then one multiply gathers the bytes)."""
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & 0xFFFFFFFF) >> 24


def range_count_popcnt(data: torch.Tensor, low, high, *, pack=to_integral) -> torch.Tensor:
    """Range count by packing each 32 lanes of the mask into a word and
    popcounting the words (the reference's ``popcnt`` definition); ``pack``
    is the mask -> uint32 packer (the plain one here, the ballot kernel on
    the card). 0-d int32, as ``ref.range_count``."""
    flat = data.reshape(-1)
    mask = (flat >= low) & (flat <= high)
    pad = -mask.numel() % 32
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return popcount32(pack(mask.view(-1, 32))).sum(dtype=torch.int32)
