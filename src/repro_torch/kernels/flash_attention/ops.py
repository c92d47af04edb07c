"""Wrapper the ``h100`` flash_attention definition calls: a CUDA tensor
launches the CUDA C++ kernel (or raises on what it does not take), a CPU
tensor takes the plain version. ``flash_attention.launches`` counts kernel
launches."""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    kv_len: int | None = None):
    """Flash attention with GQA. q (B,H,Sq,D), k/v (B,KH,Sk,D) -> (B,H,Sq,D).

    ``kv_len`` (a host int, default Sk) masks keys >= kv_len and aligns
    causality at its end: row i sees keys <= i + kv_len - Sq."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, f"flash_attention {name}", _DTYPES)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,H,Sq,D), k = v (B,KH,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kh, sk, kd = k.shape
    if kb != b or kd != d or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (batch, head dim, H % KH)")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {kernel.HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share dtype and device")
    if isinstance(kv_len, torch.Tensor):
        raise TypeError("flash_attention: kv_len must be a host int")
    kv_len = sk if kv_len is None else int(kv_len)
    if kv_len < 0:
        raise ValueError(f"flash_attention: kv_len {kv_len} < 0")
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if q.numel():
        kernel.flash_attention_4d(q, k, v, out, causal=causal, scale=scale,
                                  kv_len=kv_len, q_offset=kv_len - sq)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "ref"]
