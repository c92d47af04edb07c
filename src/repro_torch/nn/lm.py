"""Decoder-only transformer LM: the dense, moe and vlm backbones (mirrors
``repro/nn/lm.py``).

Layer params stay stacked along a leading L axis — the reference's layout,
so its params load 1:1 — and a Python loop over the layers replaces
``lax.scan``. For training, ``lm_forward(..., remat=True)`` wraps each block
in ``torch.utils.checkpoint`` as the reference wraps its scan body in
``jax.checkpoint``: a block's activations are recomputed in the backward.
Decode, prefill-chunk and the speculative verify span write the KV cache
state IN PLACE (see ``nn/attention.py``) and return it; the fused paged
decode and verify steps write the page pools in place the same way.

The moe family swaps every block's MLP for ``nn/moe.py``'s mixture of
experts; its load-balance aux term is a training term, and training the
moe family is not ported yet (ROADMAP.md, queue 1, item 15). The vlm
family projects a request's (B, vision_prefix, D) patch embeddings through
``vision_proj`` and reads them AHEAD of the first prompt token
(``embed_inputs``): ``lm_forward`` and ``lm_prefill`` take them, and so does
``lm_prefill_chunk`` on a request's first chunk, whose logits then have
prefix + C rows. The decode, verify and paged steps are unchanged.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attention_decode, attention_forward, attention_prefill_chunk,
                        attention_span_paged, attention_verify, init_attention)
from .common import apply_norm_params, init_norm
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_forward


def lm_params(cfg, make):
    """The parameter tree of ``cfg``, one ``make(kind, shape)`` per leaf."""
    L = (cfg.n_layers,)
    params = {
        "embed": make("embed", (cfg.padded_vocab, cfg.d_model)),
        "blocks": {
            "attn_norm": init_norm(cfg, make, L),
            "attn": init_attention(cfg, make, L),
            "mlp_norm": init_norm(cfg, make, L),
        },
        "final_norm": init_norm(cfg, make),
    }
    if cfg.n_experts:
        params["blocks"]["moe"] = init_moe(cfg, make, L)
    else:
        params["blocks"]["mlp"] = init_mlp(cfg, make, L)
    if not cfg.tie_embeddings:
        params["head"] = make("dense", (cfg.d_model, cfg.padded_vocab))
    if cfg.vision_prefix:
        # the stub frontend's projection stands in for the ViT adapter
        params["vision_proj"] = make("dense", (cfg.d_model, cfg.d_model))
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
    return _ffn_residual(tsl, bp, x + h, cfg), kv


def _ffn_residual(tsl, bp, x, cfg):
    """x + the block's feed-forward of its normed x: the moe family's
    mixture of experts (its aux term dropped: no ported step trains the moe
    family) or the MLP."""
    y = apply_norm_params(tsl, cfg, bp["mlp_norm"], x)
    if cfg.n_experts:
        return x + moe_forward(tsl, bp["moe"], y, cfg)[0]
    return x + mlp_forward(tsl, bp["mlp"], y, cfg)


def embed_inputs(tsl, params, tokens, cfg, vision_embeds=None):
    """The token embeddings, behind the projected vision prefix when the
    config has one and ``vision_embeds`` (B, vision_prefix, D) is given."""
    x = tsl.embed_lookup(params["embed"], tokens)
    if cfg.vision_prefix and vision_embeds is not None:
        v = tsl.matmul(vision_embeds.to(x.dtype), params["vision_proj"])
        x = torch.cat([v, x], dim=1)
    return x


def lm_forward(tsl, params, tokens, cfg, *, vision_embeds=None,
               collect_cache: bool = False, last_only: bool = False,
               remat: bool = False):
    """tokens (B,S) -> (logits (B,S',V), caches | None), S' = S plus the
    vision prefix rows when ``vision_embeds`` is given.

    ``collect_cache``: also return each layer's (k, v), (B,KH,S',hd).
    ``last_only``: logits for the final position only (prefill path —
    avoids materializing the (B,S',V) tensor).
    ``remat``: recompute each block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping them."""
    x = embed_inputs(tsl, params, tokens, cfg, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    kvs = []
    for bp in unstack_layers(params["blocks"], cfg.n_layers):
        if remat:
            # no op of a block draws random numbers, so not saving and
            # restoring the RNG state (a host-side step inside a CUDA graph
            # capture) changes no result
            x, kv = checkpoint(_block_forward, tsl, bp, x, cfg, positions,
                               use_reentrant=False, preserve_rng_state=False)
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


def lm_prefill(tsl, params, tokens, cfg, *, max_len: int, vision_embeds=None):
    """Full-sequence prefill; returns (last_logits (B,V), decode state), the
    cache filled to the vision prefix + S rows."""
    logits, kvs = lm_forward(tsl, params, tokens, cfg, vision_embeds=vision_embeds,
                             collect_cache=True, last_only=True)
    b, s = tokens.shape[0], kvs[0][0].shape[2]
    state = init_decode_state(cfg, b, max_len, params["embed"].dtype,
                              params["embed"].device)
    for i, (k, v) in enumerate(kvs):
        state["k"][i, :, :, :s] = k
        state["v"][i, :, :, :s] = v
    return logits[:, -1], state


def lm_prefill_chunk(tsl, params, state, tokens, pos, cfg, *, vision_embeds=None):
    """Continuation prefill of one chunk into a live decode state (in place).

    tokens (B,C): the next chunk of the prompt; ``pos`` is the cache fill
    before this chunk (an int, or a (B,) int device tensor, as a captured
    step passes it) — the chunk's K/V land at rows [pos, pos+C) and its
    queries attend causally to everything up to themselves. Trailing padding
    rows in the chunk need no masking (see attention_prefill_chunk); the
    caller reads logits at its last real row. ``vision_embeds`` (vlm, first
    chunk only, (B, prefix, D)) puts the projected vision prefix rows ahead
    of the chunk's: C' = prefix + C rows land at [pos, pos+C').

    Returns (logits (B, C', V), state)."""
    x = embed_inputs(tsl, params, tokens, cfg, vision_embeds)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        h, _, _ = attention_prefill_chunk(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = _ffn_residual(tsl, bp, x + h, cfg)
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
        x = _ffn_residual(tsl, bp, x + h, cfg)
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
        x = _ffn_residual(tsl, bp, x + h, cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg), state


def _lm_paged_span(tsl, params, pools, tables, tokens, pos, cfg, span_op):
    """Fused-paged decode / verify body: every layer's span attends DIRECTLY
    against its (KH, n_pages, page, hd) slice of the (L, 1, KH, n_pages, page, hd)
    pools (see attention_span_paged), written in place. ``kv_len`` = pos + C
    is computed once on the device and shared by every layer. int8 pools
    carry their (L, 1, KH, n_pages, page, 1) float32 scale pools as
    ``k__scale`` / ``v__scale``, each layer's slice beside its payload's.
    Returns (logits (B,C,V), pools)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    kv_len = (pos + tokens.shape[1]).to(torch.int32)
    int8 = "k__scale" in pools
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        scales = {"k_scale": pools["k__scale"][i, 0],
                  "v_scale": pools["v__scale"][i, 0]} if int8 else {}
        h, _, _ = attention_span_paged(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            pools["k"][i, 0], pools["v"][i, 0], tables, pos, cfg, span_op,
            kv_len=kv_len, **scales)
        x = _ffn_residual(tsl, bp, x + h, cfg)
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
