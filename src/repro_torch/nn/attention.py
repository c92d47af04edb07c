"""Attention layer on TSL primitives: GQA + RoPE + optional qk_norm/bias.

Full-sequence path uses ``tsl.flash_attention`` (the CUDA C++ kernel on
``h100``); the prefill-chunk, speculative verify-span and decode paths use
``tsl.attention_prefill_chunk`` / ``tsl.attention_verify`` /
``tsl.attention_decode`` and write the KV cache through ``tsl.cache_update``.
Cache layout (B, KH, S_max, hd), heads-major, as in the reference. The fused
paged span (``attention_span_paged``) writes its rows straight into
block-table pages and attends through ``tsl.attention_decode_paged`` or
``tsl.attention_verify_paged`` (the CUDA C++ block-table kernel on
``h100``).

KV caches are written IN PLACE (the JAX reference returns new arrays): the
caller's cache tensors are updated and returned, which is what lets the
serving engine keep one slot table without copying it every step.
"""

from __future__ import annotations

import torch

from repro_torch.dist.compression import quantize_absmax_int8

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


def attention_prefill_chunk(tsl, p, x, k_cache, v_cache, pos, cfg):
    """Continuation prefill of one chunk into an existing cache.

    x: (B, C, D) chunk activations; caches (B, KH, S_max, hd) filled to
    ``pos`` real rows: an int, or a (B,) int device tensor (what a captured
    step takes: no host value enters the step). Writes the chunk's K/V at
    rows [pos, pos+C) in place
    and attends the chunk queries against the whole cache through
    ``tsl.attention_prefill_chunk`` (causal, ends-aligned at pos+C).

    Rows the caller marks as padding need no masking here: a padded row
    sits after every real row, so the causal mask hides its key from every
    real query; its own output row is discarded by the caller, and its cache
    row lies beyond the real fill, where the decode-path kv_len mask hides it
    until the next chunk or decode step overwrites it.

    Returns (y (B,C,D), k_cache, v_cache)."""
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    return _span_attend(tsl, p, x, k_cache, v_cache, pos, cfg,
                        tsl.attention_prefill_chunk)


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


def attention_verify(tsl, p, x, k_cache, v_cache, pos, cfg):
    """Speculative-decoding verify span. x (B, SV, D) holds each slot's
    pending token and drafted continuation; ``pos`` is a (B,) tensor of
    per-slot base write rows. Writes the span's K/V at rows [pos, pos+SV) of
    each slot in place and scores every row in one ragged batched step
    through ``tsl.attention_verify`` (causal, ends-aligned at pos + SV), so
    row j's output is independent of rows > j: the accepted-prefix
    contract. Rejected rows need no rollback: they lie past the committed
    kv_len, where the decode mask hides them until they are overwritten.

    Returns (y (B,SV,D), k_cache, v_cache)."""
    return _span_attend(tsl, p, x, k_cache, v_cache, pos.to(x.device), cfg,
                        tsl.attention_verify)


def _span_attend(tsl, p, x, k_cache, v_cache, pos, cfg, span_op):
    """The prefill-chunk / verify-span body: project the C rows at base
    ``pos`` (an int, or a (B,) tensor of per-slot bases), write their K/V in
    place and attend through ``span_op`` (ends-aligned at pos + C)."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    if isinstance(pos, torch.Tensor):
        positions = pos.long()[:, None] + torch.arange(c, device=x.device)[None, :]
    else:
        positions = torch.arange(pos, pos + c, device=x.device)
    q, k, v = _project_qkv(tsl, p, x, cfg, positions)
    # cache_update writes along axis 1: hand it the (B, S, KH, hd) views
    tsl.cache_update(k_cache.transpose(1, 2), k.transpose(1, 2), pos)
    tsl.cache_update(v_cache.transpose(1, 2), v.transpose(1, 2), pos)
    o = span_op(q, k_cache, v_cache, kv_len=pos + c)
    o = o.transpose(1, 2).reshape(b, c, h * hd)
    return tsl.matmul(o, p["wo"]), k_cache, v_cache


def attention_span_paged(tsl, p, x, k_pool, v_pool, tables, pos, cfg, span_op, *,
                         kv_len, k_scale=None, v_scale=None):
    """Fused paged decode or verify span: project C tokens per slot, write
    each row STRAIGHT into its block-table page and attend directly against
    the page pool — no page->lane gather anywhere.

    x (B, C, D) span activations (C == 1 is the decode step, C = k + 1 a
    speculative verify span); pools
    (KH, n_pages, page, hd) — one layer's slice of the serve-layer pool,
    written IN PLACE; tables (B, P) int32 page ids on x's device; ``pos`` a
    (B,) device tensor of per-slot base write positions. ``span_op`` is
    ``tsl.attention_decode_paged`` (C == 1) or ``tsl.attention_verify_paged``;
    both mask ends-aligned at ``kv_len``, the (B,) int32 device tensor pos + C
    that every layer shares, so rows past a slot's fill are dead and a
    rejected draft's rows need no rollback. Inactive slots must point
    at a scratch page (a valid id): their row writes and reads land there.
    ``k_scale`` / ``v_scale`` (KH, n_pages, page, 1) float32 switch the
    pools to the absmax-int8 wire format (``dist/compression.py``): each
    written row is quantized, its int8 payload and its scale written in
    place at the same (page, offset), and the primitive dequantizes per
    touched page.

    Returns (y (B,C,D), k_pool, v_pool)."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    page = k_pool.shape[-2]
    positions = pos.long()[:, None] + torch.arange(c, device=pos.device)[None, :]
    q, k, v = _project_qkv(tsl, p, x, cfg, positions)          # positions (B, C)
    pid = torch.gather(tables, 1, positions // page).long()
    off = positions % page
    # pool[:, pid, off] broadcasts the (B, C) index pair under the KH slice:
    # (KH, B, C, hd) slabs, heads-major like the pool
    kr, vr = k.transpose(0, 1), v.transpose(0, 1)
    if k_scale is not None:
        (qk, sk), (qv, sv) = quantize_absmax_int8(kr), quantize_absmax_int8(vr)
        k_pool[:, pid, off] = qk
        v_pool[:, pid, off] = qv
        k_scale[:, pid, off] = sk
        v_scale[:, pid, off] = sv
    else:
        k_pool[:, pid, off] = kr.to(k_pool.dtype)
        v_pool[:, pid, off] = vr.to(v_pool.dtype)
    o = span_op(q.contiguous(), k_pool, v_pool, tables, kv_len=kv_len, k_scale=k_scale,
                v_scale=v_scale)
    o = o.transpose(1, 2).reshape(b, c, h * hd)
    return tsl.matmul(o, p["wo"]), k_pool, v_pool
