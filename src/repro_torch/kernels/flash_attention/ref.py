"""Plain PyTorch attention (mirrors ``repro/kernels/flash_attention/ref.py``):
``attention`` is the ``torch_cpu`` flash_attention definition and what the
Hopper kernel is held against; ``attention_chunked`` and
``attention_decode`` are the prefill-chunk and decode primitives on both
targets (jnp on every target in the JAX package too).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    # (B, KH, S, D) -> (B, KH*groups, S, D)
    return k.repeat_interleave(groups, dim=1)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              kv_len: int | None = None):
    """q: (B,H,Sq,D); k,v: (B,KH,Sk,D) with H % KH == 0. Returns (B,H,Sq,D).

    kv_len masks out key positions >= kv_len (padding) AND sets the causal
    alignment: the last q row sits at logical position kv_len - 1, not
    Sk - 1 (prefill continuation against a padded cache). Fully masked rows
    output exactly 0."""
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    assert h % kh == 0, (h, kh)
    if h != kh:
        k = _expand_kv(k, h // kh)
        v = _expand_kv(v, h // kh)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    ki = torch.arange(sk, device=q.device)[None, :]
    if causal:
        end = kv_len if kv_len is not None else sk
        qi = torch.arange(sq, device=q.device)[:, None] + (end - sq)
        s = torch.where(qi >= ki, s, NEG_INF)
    if kv_len is not None:
        s = torch.where(ki < kv_len, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30), v.float())
    o = torch.where(m > -1e29, o, 0.0)
    return o.to(q.dtype)


def _kv_vector(kv_len, b: int, sk: int, device) -> torch.Tensor:
    """kv_len (None, int, 0-d or (B,) tensor) as a (B,) int64 device tensor."""
    if kv_len is None:
        kv_len = sk
    return torch.as_tensor(kv_len, device=device).long().expand(b)


def attention_chunked(q, k, v, *, causal: bool = True, scale: float | None = None,
                      kv_len=None, block_k: int = 1024):
    """Flash-style chunked attention in plain torch: a loop over key blocks
    with an online-softmax carry, so the (Sq, Sk) score matrix never
    materializes. ``kv_len`` may be a scalar or a (B,) vector of
    per-sequence cache fills. Same formulas as the JAX reference, row for
    row (including its treatment of fully masked rows)."""
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    assert h % kh == 0
    g = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kv_vec = _kv_vector(kv_len, b, sk, q.device)                # (B,)
    bk = min(block_k, sk)
    qg = q.reshape(b, kh, g, sq, d).float()
    q_pos = torch.arange(sq, device=q.device)[None, :] + (kv_vec[:, None] - sq)
    m = torch.full((b, kh, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, sq, 1), device=q.device)
    acc = torch.zeros((b, kh, g, sq, d), device=q.device)
    for k0 in range(0, sk, bk):
        kt = k[:, :, k0:k0 + bk].float()
        vt = v[:, :, k0:k0 + bk].float()
        if kt.shape[2] < bk:                       # zero-pad the last block
            pad = bk - kt.shape[2]
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = torch.einsum("bkgqd,bked->bkgqe", qg, kt) * scale  # (B,KH,G,Sq,bk)
        k_pos = k0 + torch.arange(bk, device=q.device)
        mask = k_pos[None, None, :] < kv_vec[:, None, None]     # (B,1,bk)
        if causal:
            mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqe,bked->bkgqd", p, vt)
        m = m_new
    o = acc / l.clamp_min(1e-30)
    o = torch.where(l > 0.0, o, 0.0)
    return o.reshape(b, h, sq, d).to(q.dtype)


def attention_decode(q, k_cache, v_cache, *, kv_len=None, scale: float | None = None):
    """Single-token decode: q (B,H,1,D) vs caches (B,KH,S,D), GQA-grouped
    (the cache is never head-expanded). ``kv_len`` may be a scalar or a (B,)
    vector of per-sequence fills (each slot at its own position)."""
    b, h, _, d = q.shape
    _, kh, s_max, _ = k_cache.shape
    g = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    if kv_len is not None:
        kvl = _kv_vector(kv_len, b, s_max, q.device).view(b, 1, 1, 1)
        s = torch.where(torch.arange(s_max, device=q.device) < kvl, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.reshape(b, h, 1, d).to(q.dtype)
