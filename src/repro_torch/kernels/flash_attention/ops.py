"""Wrappers the ``h100`` flash_attention and flash_attention_bwd definitions
call: a CUDA tensor launches the CUDA C++ kernels (or raises on what they
do not take), a CPU tensor takes their plain versions (``ref``). Each kernel
wrapper counts its launches: ``flash_attention.launches`` (the serving
forward), ``flash_attention_fwd_lse.launches``,
``flash_attention_bwd_dq.launches`` and ``flash_attention_bwd_dkv.launches``.

Differentiable as in the reference (``repro/kernels/flash_attention/ops.py``):
:class:`FlashAttention` saves q, k, v, the output and the (B,H,Sq) f32
logsumexp (never the (Sq, Sk) matrix) and its backward runs the dq and
dk/dv recomputation kernels. :func:`flash_attention` goes through it when
autograd needs a gradient of q, k or v, and keeps the no-lse serving forward
otherwise.
"""

from __future__ import annotations

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, kv_len, scale, name: str):
    """Validate the operands of a kernel launch; returns (kv_len, scale).
    Every kernel (the serving forward, the lse forward, dq and dk/dv) is
    built at kernel.HEAD_DIMS."""
    for label, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, f"{name} {label}", _DTYPES)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,H,Sq,D), k = v (B,KH,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kh, sk, kd = k.shape
    if kb != b or kd != d or kh == 0 or h % kh:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (batch, head dim, H % KH)")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {kernel.HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must share dtype and device")
    if isinstance(kv_len, torch.Tensor):
        raise TypeError(f"{name}: kv_len must be a host int")
    kv_len = sk if kv_len is None else int(kv_len)
    if kv_len < 0:
        raise ValueError(f"{name}: kv_len {kv_len} < 0")
    return kv_len, float(scale) if scale is not None else 1.0 / (d ** 0.5)


def _check_rows(q, name: str, **rows):
    """The (B,H,Sq) float32 residuals (lse, delta) and dO beside q."""
    for label, t in rows.items():
        want = q.shape if label == "do" else q.shape[:3]
        dtypes = (q.dtype,) if label == "do" else (torch.float32,)
        check_cuda_tensor(t, f"{name} {label}", dtypes)
        if t.shape != want or t.device != q.device:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} on {t.device}, "
                             f"want {tuple(want)} on {q.device}")


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            scale: float | None = None, kv_len: int | None = None):
    """(out (B,H,Sq,D), lse (B,H,Sq) f32): the training forward, whose lse
    is 0 on a row that sees no key."""
    if q.device.type == "cpu":
        return ref.attention_fwd_lse(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    kv_len, scale = _check(q, k, v, kv_len, scale, "flash_attention_fwd_lse")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        kernel.flash_attention_4d(q, k, v, out, causal=causal, scale=scale, kv_len=kv_len,
                                  q_offset=kv_len - q.shape[2], lse=lse)
        flash_attention_fwd_lse.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           scale: float | None = None, kv_len: int | None = None):
    """dq (B,H,Sq,D) in q's dtype (the q-tiled recomputation kernel)."""
    if q.device.type == "cpu":
        return ref.attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale,
                                    kv_len=kv_len)
    kv_len, scale = _check(q, k, v, kv_len, scale, "flash_attention_bwd_dq")
    _check_rows(q, "flash_attention_bwd_dq", do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if q.numel():
        kernel.flash_attention_bwd_dq_4d(q, k, v, do, lse, delta, dq, causal=causal,
                                         scale=scale, kv_len=kv_len,
                                         q_offset=kv_len - q.shape[2])
        flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            scale: float | None = None, kv_len: int | None = None):
    """float32 (dk, dv), (B,H,Sk,D) per QUERY head (the k-tiled kernel)."""
    if q.device.type == "cpu":
        return ref.attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale,
                                     kv_len=kv_len)
    kv_len, scale = _check(q, k, v, kv_len, scale, "flash_attention_bwd_dkv")
    _check_rows(q, "flash_attention_bwd_dkv", do=do, lse=lse, delta=delta)
    shape = (q.shape[0], q.shape[1], k.shape[2], q.shape[3])
    dk = torch.empty(shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(shape, dtype=torch.float32, device=q.device)
    if dk.numel():          # with Sq == 0 the kernel writes zeros
        kernel.flash_attention_bwd_dkv_4d(q, k, v, do, lse, delta, dk, dv, causal=causal,
                                          scale=scale, kv_len=kv_len,
                                          q_offset=kv_len - q.shape[2])
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _backward(q, k, v, g, out, lse, *, causal, scale, kv_len):
    """(dq, dk, dv) in the input dtypes: delta = rowsum(g * out) in f32, the
    dq and dk/dv kernels (or their plain versions), then each group of H/KH
    query heads summed onto its KV head in f32 (reference ops.py:60-72)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    delta = (g.float() * out.float()).sum(-1)
    g = g.to(q.dtype).contiguous()
    kw = dict(causal=causal, scale=scale, kv_len=kv_len)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    dk = dk.view(b, kh, h // kh, sk, d).sum(2).to(k.dtype)
    dv = dv.view(b, kh, h // kh, sk, d).sum(2).to(v.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the recomputation backward. Saves q, k, v, out
    and the O(Sq) lse; the backward's kernels recompute the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale,
                                           kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, g, out, lse, **ctx.kw), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    kv_len: int | None = None):
    """Flash attention with GQA. q (B,H,Sq,D), k/v (B,KH,Sk,D) -> (B,H,Sq,D).

    ``kv_len`` (a host int, default Sk) masks keys >= kv_len and aligns
    causality at its end: row i sees keys <= i + kv_len - Sq. Differentiable
    through :class:`FlashAttention` when a gradient of q, k or v is needed."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, kv_len)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    kv_len, scale = _check(q, k, v, kv_len, scale, "flash_attention")
    out = torch.empty_like(q)
    if q.numel():
        kernel.flash_attention_4d(q, k, v, out, causal=causal, scale=scale,
                                  kv_len=kv_len, q_offset=kv_len - q.shape[2])
        flash_attention.launches += 1
    return out


def flash_attention_vjp(q, k, v, g, *, causal: bool = True, scale: float | None = None,
                        kv_len: int | None = None):
    """(dq, dk, dv) for cotangent ``g``: the UPD ``flash_attention_bwd``
    entry point (reference ops.py:104-125). Re-runs the lse forward, then
    the backward kernels."""
    out, lse = flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    return _backward(q, k, v, g, out, lse, causal=causal, scale=scale, kv_len=kv_len)


for _wrapper in (flash_attention, flash_attention_fwd_lse, flash_attention_bwd_dq,
                 flash_attention_bwd_dkv):
    _wrapper.launches = 0

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd_lse", "flash_attention_vjp",
           "ref"]
