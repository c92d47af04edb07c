"""Attention layer on TSL primitives: GQA + RoPE + optional qk_norm/bias.

Full-sequence path uses ``tsl.flash_attention`` (the CUDA C++ kernel on
``h100``); the prefill-chunk and decode paths use
``tsl.attention_prefill_chunk`` / ``tsl.attention_decode`` and write the KV
cache through ``tsl.cache_update``. Cache layout (B, KH, S_max, hd),
heads-major, as in the reference.

KV caches are written IN PLACE (the JAX reference returns new arrays): the
caller's cache tensors are updated and returned, which is what lets the
serving engine keep one slot table without copying it every step.
"""

from __future__ import annotations

import torch

from .rope import rope_tables


def init_attention(cfg, make, lead=()):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": make("dense", (*lead, d, h * hd)),
        "wk": make("dense", (*lead, d, kh * hd)),
        "wv": make("dense", (*lead, d, kh * hd)),
        "wo": make("dense", (*lead, h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = make("zeros", (*lead, h * hd))
        p["bk"] = make("zeros", (*lead, kh * hd))
        p["bv"] = make("zeros", (*lead, kh * hd))
    if cfg.qk_norm:
        p["q_norm"] = make("ones", (*lead, hd))
        p["k_norm"] = make("ones", (*lead, hd))
    return p


def _rope(positions: torch.Tensor, cfg):
    """(cos, sin) broadcastable against (B, S, heads, hd/2): ``positions``
    is (S,) shared by the batch, or (B, S) per sequence."""
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    if cos.ndim == 2:
        return cos[:, None, :], sin[:, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]


def _project_qkv(tsl, p, x, cfg, positions):
    """x: (B,S,D) -> q (B,H,S,hd), k/v (B,KH,S,hd) heads-major views, RoPE applied."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = tsl.matmul(x, p["wq"])
    k = tsl.matmul(x, p["wk"])
    v = tsl.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = tsl.rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = tsl.rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    cos, sin = _rope(positions, cfg)
    q = tsl.rope_apply(q, cos, sin)
    k = tsl.rope_apply(k, cos, sin)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_forward(tsl, p, x, cfg, *, causal: bool = True, positions=None):
    """Full-sequence attention. x: (B,S,D) -> (B,S,D); returns (y, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(tsl, p, x, cfg, positions)
    # the flash kernel takes contiguous heads-major tensors
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = tsl.flash_attention(q, k, v, causal=causal)          # (B,H,S,hd)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return tsl.matmul(o, p["wo"]), (k, v)


def attention_prefill_chunk(tsl, p, x, k_cache, v_cache, pos: int, cfg):
    """Continuation prefill of one chunk into an existing cache.

    x: (B, C, D) chunk activations; caches (B, KH, S_max, hd) filled to
    ``pos`` real rows. Writes the chunk's K/V at rows [pos, pos+C) in place
    and attends the chunk queries against the whole cache through
    ``tsl.attention_prefill_chunk`` (causal, ends-aligned at pos+C).

    Rows the caller marks as padding need no masking here: a padded row
    sits after every real row, so the causal mask hides its key from every
    real query; its own output row is discarded by the caller, and its cache
    row lies beyond the real fill, where the decode-path kv_len mask hides it
    until the next chunk or decode step overwrites it.

    Returns (y (B,C,D), k_cache, v_cache)."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    pos = int(pos)
    positions = torch.arange(pos, pos + c, device=x.device)
    q, k, v = _project_qkv(tsl, p, x, cfg, positions)
    # cache_update writes along axis 1: hand it the (B, S, KH, hd) views
    tsl.cache_update(k_cache.transpose(1, 2), k.transpose(1, 2), pos)
    tsl.cache_update(v_cache.transpose(1, 2), v.transpose(1, 2), pos)
    o = tsl.attention_prefill_chunk(q, k_cache, v_cache, kv_len=pos + c)
    o = o.transpose(1, 2).reshape(b, c, h * hd)
    return tsl.matmul(o, p["wo"]), k_cache, v_cache


def attention_decode(tsl, p, x_t, k_cache, v_cache, pos, cfg):
    """One-token decode. x_t: (B,1,D); caches (B,KH,S_max,hd); ``pos``: the
    write index (int), or a (B,) int tensor of PER-SLOT write indices
    (continuous batching: RoPE, the cache write and the kv_len mask all
    become per-slot). Writes the caches in place.

    Returns (y (B,1,D), k_cache, v_cache)."""
    b = x_t.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(x_t.device)
        positions = pos[:, None]                             # (B, 1)
    else:
        pos = int(pos)
        positions = torch.tensor([pos], device=x_t.device)   # (1,)
    q, k, v = _project_qkv(tsl, p, x_t, cfg, positions)
    tsl.cache_update(k_cache.transpose(1, 2), k.transpose(1, 2), pos)
    tsl.cache_update(v_cache.transpose(1, 2), v.transpose(1, 2), pos)
    o = tsl.attention_decode(q, k_cache, v_cache, kv_len=pos + 1)
    o = o.transpose(1, 2).reshape(b, 1, h * hd)
    return tsl.matmul(o, p["wo"]), k_cache, v_cache
