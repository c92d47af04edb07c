"""Decoder-only transformer LM, dense family (mirrors ``repro/nn/lm.py``).

Layer params stay stacked along a leading L axis — the reference's layout,
so its params load 1:1 — and a Python loop over the layers replaces
``lax.scan``. Decode and prefill-chunk write the KV cache state IN PLACE
(see ``nn/attention.py``) and return it.
"""

from __future__ import annotations

import torch

from .attention import (attention_decode, attention_forward, attention_prefill_chunk,
                        init_attention)
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


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _block_forward(tsl, bp, x, cfg, positions):
    h, kv = attention_forward(tsl, bp["attn"],
                              apply_norm_params(tsl, cfg, bp["attn_norm"], x),
                              cfg, causal=True, positions=positions)
    x = x + h
    y = mlp_forward(tsl, bp["mlp"], apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    return x + y, kv


def lm_forward(tsl, params, tokens, cfg, *, collect_cache: bool = False,
               last_only: bool = False):
    """tokens (B,S) -> (logits (B,S,V), caches | None).

    ``collect_cache``: also return each layer's (k, v), (B,KH,S,hd).
    ``last_only``: logits for the final position only (prefill path —
    avoids materializing the (B,S,V) tensor)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = _block_forward(tsl, layer_params(params["blocks"], i), x, cfg,
                               positions)
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


def lm_prefill_chunk(tsl, params, state, tokens, pos: int, cfg):
    """Continuation prefill of one chunk into a live decode state (in place).

    tokens (B,C): the next chunk of the prompt; ``pos`` is the cache fill
    before this chunk — the chunk's K/V land at rows [pos, pos+C) and its
    queries attend causally to everything up to themselves. Trailing padding
    rows in the chunk need no masking (see attention_prefill_chunk); the
    caller reads logits at its last real row.

    Returns (logits (B, C, V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
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
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, _, _ = attention_decode(
            tsl, bp["attn"], apply_norm_params(tsl, cfg, bp["attn_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = x + h
        x = x + mlp_forward(tsl, bp["mlp"],
                            apply_norm_params(tsl, cfg, bp["mlp_norm"], x), cfg)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg)[:, 0], state
