"""Decoder-only transformer LM, dense family (mirrors ``repro/nn/lm.py``).

Layer params stay stacked along a leading L axis — the reference's layout,
so its params load 1:1 — and a Python loop over the layers replaces
``lax.scan``. For training, ``lm_forward(..., remat=True)`` wraps each block
in ``torch.utils.checkpoint`` as the reference wraps its scan body in
``jax.checkpoint``: a block's activations are recomputed in the backward.
Decode, prefill-chunk and the speculative verify span write the KV cache
state IN PLACE (see ``nn/attention.py``) and return it; the fused paged
decode and verify steps write the page pools in place the same way.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attention_decode, attention_forward, attention_prefill_chunk,
                        attention_span_paged, attention_verify, init_attention)
from .common import apply_norm_params, init_norm
from .mlp import init_mlp, mlp_forward


def lm_params(cfg, make):
    """The parameter tree of ``cfg``, one ``make(kind, shape)`` per leaf."""
    L = (cfg.n_layers,)
    params = {
        "embed": make("embed", (cfg.padded_vocab, cfg.d_model)),
        "blocks": {
            "attn_norm": init_norm(cfg, make, L),
            "attn": init_attention(cfg, make, L),
            "mlp_norm": init_norm(cfg, make, L),
            "mlp": init_mlp(cfg, make, L),
        },
        "final_norm": init_norm(cfg, make),
    }
    if not cfg.tie_embeddings:
        params["head"] = make("dense", (cfg.d_model, cfg.padded_vocab))
    return params


def unstack_layers(blocks: dict, n: int) -> list[dict]:
    """Every layer's slice of the stacked block params (views, no copy),
    one ``unbind`` per leaf: autograd then stacks the layers' gradients in
    one op per leaf, where ``n`` separate slices would each add a zero-filled
    (L, ...) gradient into the leaf's."""
    cols = {k: unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in blocks.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _block_forward(tsl, bp, x, cfg, positions):
    h, kv = attention_forward(tsl, bp["attn"],
                              apply_norm_params(tsl, cfg, bp["attn_norm"], x),
                              cfg, causal=True, positions=positions)
    x = x + h
    y = mlp_forward(tsl, bp["mlp"], apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    return x + y, kv


def lm_forward(tsl, params, tokens, cfg, *, collect_cache: bool = False,
               last_only: bool = False, remat: bool = False):
    """tokens (B,S) -> (logits (B,S,V), caches | None).

    ``collect_cache``: also return each layer's (k, v), (B,KH,S,hd).
    ``last_only``: logits for the final position only (prefill path —
    avoids materializing the (B,S,V) tensor).
    ``remat``: recompute each block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping them."""
    x = tsl.embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    kvs = []
    for bp in unstack_layers(params["blocks"], cfg.n_layers):
        if remat:
            x, kv = checkpoint(_block_forward, tsl, bp, x, cfg, positions,
                               use_reentrant=False)
        else:
            x, kv = _block_forward(tsl, bp, x, cfg, positions)
        if collect_cache:
            kvs.append(kv)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return lm_head(tsl, params, x, cfg), (kvs if collect_cache else None)


def lm_head(tsl, params, x, cfg):
    if cfg.tie_embeddings:
        return tsl.matmul(x, params["embed"].T)
    return tsl.matmul(x, params["head"])


def init_decode_state(cfg, batch: int, max_len: int, dtype, device):
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def state_batch_axes(state):
    """Slot-axis position per state leaf (serve-layer state surgery): KV
    cache leaves are (L, B, KH, S_max, hd) — the request axis sits at 1."""
    return {k: 1 for k in state}


def state_page_axes(state):
    """Token-axis position per state leaf for PAGED serving (None = not
    paged): every KV leaf (L, B, KH, S_max, hd) grows along axis 3, one row
    per cache token, so both leaves page. KV rows depend only on their
    absolute position (rotary at write time), which is what makes prefix
    pages exactly shareable."""
    return {k: 3 for k in state}


def lm_prefill(tsl, params, tokens, cfg, *, max_len: int):
    """Full-sequence prefill; returns (last_logits (B,V), decode state)."""
    logits, kvs = lm_forward(tsl, params, tokens, cfg, collect_cache=True,
                             last_only=True)
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_len, params["embed"].dtype,
                              params["embed"].device)
    for i, (k, v) in enumerate(kvs):
        state["k"][i, :, :, :s] = k
        state["v"][i, :, :, :s] = v
    return logits[:, -1], state


def lm_prefill_chunk(tsl, params, state, tokens, pos, cfg):
    """Continuation prefill of one chunk into a live decode state (in place).

    tokens (B,C): the next chunk of the prompt; ``pos`` is the cache fill
    before this chunk (an int, or a (B,) int device tensor, as a captured
    step passes it) — the chunk's K/V land at rows [pos, pos+C) and its
    queries attend causally to everything up to themselves. Trailing padding
    rows in the chunk need no masking (see attention_prefill_chunk); the
    caller reads logits at its last real row.

    Returns (logits (B, C, V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        h, _, _ = attention_prefill_chunk(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = x + h
        x = x + mlp_forward(tsl, bp["mlp"],
                            apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg), state


def lm_decode_step(tsl, params, state, tokens_t, pos, cfg):
    """tokens_t (B,1); ``pos``: int write index, or a (B,) tensor of per-slot
    indices (continuous batching — see attention_decode). Updates ``state``
    in place; returns (logits (B,V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens_t)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        h, _, _ = attention_decode(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = x + h
        x = x + mlp_forward(tsl, bp["mlp"],
                            apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg)[:, 0], state


def lm_verify_step(tsl, params, state, tokens, pos, cfg):
    """Speculative-decoding verify span. tokens (B,SV): each slot's pending
    token and drafted continuation; ``pos`` a (B,) tensor of per-slot base
    write rows. The span's K/V land at rows [pos, pos+SV) in place; one
    ragged batched attention_verify per layer scores every row (logits row j
    validates draft j+1). Rollback is free for this family: the accepted
    fill pos+m+1 stops short of the rejected rows, which the decode mask
    hides until they are overwritten. Returns (logits (B,SV,V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    pos = pos.to(x.device)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        h, _, _ = attention_verify(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = x + h
        x = x + mlp_forward(tsl, bp["mlp"],
                            apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg), state


def _lm_paged_span(tsl, params, pools, tables, tokens, pos, cfg, span_op):
    """Fused-paged decode / verify body: every layer's span attends DIRECTLY
    against its (KH, n_pages, page, hd) slice of the (L, 1, KH, n_pages, page, hd)
    pools (see attention_span_paged), written in place. ``kv_len`` = pos + C
    is computed once on the device and shared by every layer.
    Returns (logits (B,C,V), pools)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    kv_len = (pos + tokens.shape[1]).to(torch.int32)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        h, _, _ = attention_span_paged(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            pools["k"][i, 0], pools["v"][i, 0], tables, pos, cfg, span_op,
            kv_len=kv_len)
        x = x + h
        x = x + mlp_forward(tsl, bp["mlp"],
                            apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg), pools


def lm_decode_step_paged(tsl, params, state, pools, tables, tokens_t, pos, cfg):
    """Fused paged decode: tokens_t (B,1) scored straight off the page pools
    through ``tsl.attention_decode_paged`` (tables (B,P) int32 page ids,
    ``pos`` (B,) per-slot positions, both on the device). ``state`` is the
    family's TAIL-only dict — empty for this family (every leaf pages) —
    passed through untouched. Returns (logits (B,V), state, pools)."""
    logits, pools = _lm_paged_span(tsl, params, pools, tables, tokens_t, pos, cfg,
                                   tsl.attention_decode_paged)
    return logits[:, 0], state, pools


def lm_verify_step_paged(tsl, params, state, pools, tables, tokens, pos, cfg):
    """Fused paged verify span: tokens (B,SV) scored in one ragged batched
    ``tsl.attention_verify_paged`` pass per layer (the CUDA C++ block-table
    kernel on ``h100``); the span's K/V rows land in their pages in place,
    and rejected rows sit past the committed kv_len — rollback is free, as
    in the lane path. Returns (logits (B,SV,V), state, pools)."""
    logits, pools = _lm_paged_span(tsl, params, pools, tables, tokens, pos, cfg,
                                   tsl.attention_verify_paged)
    return logits, state, pools
