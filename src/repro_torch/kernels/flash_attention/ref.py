"""Plain PyTorch attention (mirrors ``repro/kernels/flash_attention/ref.py``):
``attention`` is the ``torch_cpu`` flash_attention definition and what the
Hopper forward kernel is held against; ``attention_chunked`` and
``attention_decode`` are the prefill-chunk and decode primitives on both
targets (jnp on every target in the JAX package too).

``attention_fwd_lse``, ``attention_bwd_dq`` and ``attention_bwd_dkv`` are the
plain versions of the training kernels (the forward that also returns the
logsumexp, and the two recomputation backward kernels): the explicit
formulas of the reference's Pallas kernels
(``repro/kernels/flash_attention/kernel.py:208-297``), not torch autograd.
``ops.FlashAttention`` runs them on CPU tensors, and the kernels are held
against them on the card.
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


def visible(sq: int, sk: int, *, causal: bool, kv_len: int | None, device) -> torch.Tensor:
    """(Sq, Sk) bool: row i sees key j iff j < kv_len (default Sk) and, when
    causal, j <= i + kv_len - Sq (ends-aligned, as :func:`attention`)."""
    end = sk if kv_len is None else kv_len
    kj = torch.arange(sk, device=device)[None, :]
    seen = kj < end
    if causal:
        seen = seen & (kj <= torch.arange(sq, device=device)[:, None] + (end - sq))
    return seen.expand(sq, sk)


def _per_query_head(t: torch.Tensor, h: int) -> torch.Tensor:
    """k or v (B,KH,S,D) as float32 (B,H,S,D): KV head h // (H/KH) per query head."""
    return (_expand_kv(t, h // t.shape[1]) if h != t.shape[1] else t).float()


def _scale(scale, d: int) -> float:
    return scale if scale is not None else 1.0 / (d ** 0.5)


def _probs_and_ds(q, k, v, do, lse, delta, *, causal, scale, kv_len):
    """f32 (B,H,Sq,Sk) p = exp(scale q.k - lse), exactly 0 where masked, and
    ds = p (dO.v - delta)."""
    h = q.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), _per_query_head(k, h)) * scale
    seen = visible(q.shape[2], k.shape[2], causal=causal, kv_len=kv_len, device=q.device)
    p = torch.where(seen, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), _per_query_head(v, h))
    return p, p * (dp - delta[..., None])


def attention_fwd_lse(q, k, v, *, causal: bool = True, scale: float | None = None,
                      kv_len: int | None = None):
    """:func:`attention` that also returns the (B,H,Sq) f32 logsumexp of the
    masked scaled scores, m + log(l): 0 on a row that sees no key (whose
    output is 0), as the reference kernel writes it (kernel.py:123-129)."""
    h = q.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), _per_query_head(k, h)) \
        * _scale(scale, q.shape[3])
    seen = visible(q.shape[2], k.shape[2], causal=causal, kv_len=kv_len, device=q.device)
    s = torch.where(seen, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30), _per_query_head(v, h))
    o = torch.where(l > 0.0, o, 0.0)
    lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(1e-30)), 0.0)[..., 0]
    return o.to(q.dtype), lse


def attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                     scale: float | None = None, kv_len: int | None = None):
    """dq = scale * sum_j p (dO.v_j - delta) k_j in q's dtype, from the
    forward's (B,H,Sq) f32 ``lse`` and ``delta`` = rowsum(dO * O) in f32."""
    sc = _scale(scale, q.shape[3])
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, scale=sc, kv_len=kv_len)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, _per_query_head(k, q.shape[1]))
            * sc).to(q.dtype)


def attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                      scale: float | None = None, kv_len: int | None = None):
    """f32 (dk, dv) per QUERY head, (B,H,Sk,D) each: dv = p^T dO and
    dk = scale * ds^T q; the caller sums each head group onto its KV head."""
    sc = _scale(scale, q.shape[3])
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, scale=sc, kv_len=kv_len)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sc
    return dk, dv


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
