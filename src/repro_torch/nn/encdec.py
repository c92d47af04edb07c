"""Whisper-style encoder-decoder backbone, the ``audio`` family (mirrors
``repro/nn/encdec.py``; the conv frontend is a stub there too: the encoder
takes precomputed frame embeddings (B, enc_len, D)).

Encoder: bidirectional self-attention (the non-causal flash forward) + GELU
MLP, LayerNorm. Decoder: causal self-attention over a KV cache,
cross-attention against the encoder's K/V (projected once, at prefill or on
the first prefill chunk) and a GELU MLP. Positions: a sinusoid added to the
encoder's input, RoPE in both self-attentions (the reference's documented
deviation from Whisper's learned positions).

Layer params stay stacked, ``enc_blocks`` (n_enc_layers, ...) and
``dec_blocks`` (n_layers, ...), the reference's layout, so its params load
1:1; Python loops replace its ``lax.scan``. For training,
``encdec_forward(..., remat=True)`` checkpoints each encoder block and each
decoder block, the cross K/V projection inside it. The decode state holds the
decoder's self-attention caches ``k`` / ``v`` (L, B, KH, S, hd), which grow
one row a token and page in paged serving, and the cross K/V ``cross_k`` /
``cross_v`` (L, B, KH, enc_len, hd), fixed per request: tails, never paged.
As in ``nn/lm.py``, state and page pools are written IN PLACE (the
reference returns new arrays); the verify steps write their span's rows, and
rollback is free (rejected rows lie past the committed fill).
"""

from __future__ import annotations

import numpy as np
import torch

from .attention import (attention_decode, attention_forward, attention_prefill_chunk,
                        attention_span_paged, attention_verify, cross_attention_forward,
                        init_attention, project_kv)
from .common import apply_norm_params, init_norm
from .lm import run_block, unstack_layers
from .mlp import init_mlp, mlp_forward

_SINUSOID: dict = {}


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """The (s, d) float32 position table of ``repro/nn/encdec.py:34-45``,
    computed on the host in numpy as the reference does, copied to the
    device once per (s, d, device): a captured step's body reads the cached
    tensor (its warm-up, which runs eagerly, fills the cache), so no host
    copy enters a capture."""
    key = (s, d, str(device))
    if key not in _SINUSOID:
        pos = np.arange(s, dtype=np.float32)[:, None]
        dim = np.arange(d // 2, dtype=np.float32)[None, :]
        ang = pos / np.power(10000.0, 2 * dim / d)
        table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
        _SINUSOID[key] = torch.from_numpy(table).to(device)
    return _SINUSOID[key]


def encdec_params(cfg, make):
    """The parameter tree of ``cfg``, one ``make(kind, shape)`` per leaf."""
    E, L = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": make("embed", (cfg.padded_vocab, cfg.d_model)),
        "enc_blocks": {
            "attn_norm": init_norm(cfg, make, E),
            "attn": init_attention(cfg, make, E),
            "mlp_norm": init_norm(cfg, make, E),
            "mlp": init_mlp(cfg, make, E),
        },
        "enc_norm": init_norm(cfg, make),
        "dec_blocks": {
            "self_norm": init_norm(cfg, make, L),
            "self_attn": init_attention(cfg, make, L),
            "cross_norm": init_norm(cfg, make, L),
            "cross_attn": init_attention(cfg, make, L),
            "mlp_norm": init_norm(cfg, make, L),
            "mlp": init_mlp(cfg, make, L),
        },
        "final_norm": init_norm(cfg, make),
        "head": make("dense", (cfg.d_model, cfg.padded_vocab)),
    }


def _dec_layers(params, cfg) -> list[dict]:
    return unstack_layers(params["dec_blocks"], cfg.n_layers)


def _head(tsl, params, cfg, x):
    return tsl.matmul(apply_norm_params(tsl, cfg, params["final_norm"], x), params["head"])


def _enc_block(tsl, bp, x, cfg, positions):
    h, _ = attention_forward(tsl, bp["attn"],
                             apply_norm_params(tsl, cfg, bp["attn_norm"], x), cfg,
                             causal=False, positions=positions)
    x = x + h
    return x + mlp_forward(tsl, bp["mlp"], apply_norm_params(tsl, cfg, bp["mlp_norm"], x),
                           cfg)


def encode(tsl, params, audio_embeds, cfg, *, remat: bool = False):
    """audio_embeds (B, S, D) -> the encoder's output (B, S, D). ``remat``:
    each block under one checkpoint (``nn/lm.run_block``)."""
    s, d = audio_embeds.shape[1], audio_embeds.shape[2]
    x = audio_embeds + _sinusoid(s, d, audio_embeds.device).to(audio_embeds.dtype)
    positions = torch.arange(s, device=x.device)
    for bp in unstack_layers(params["enc_blocks"], cfg.n_enc_layers):
        x = run_block(_enc_block, tsl, bp, x, cfg, positions, remat=remat)
    return apply_norm_params(tsl, cfg, params["enc_norm"], x)


def _cross(tsl, bp, x, ck, cv, cfg):
    """The cross-attention sublayer and the MLP after it, residuals added."""
    x = x + cross_attention_forward(tsl, bp["cross_attn"],
                                    apply_norm_params(tsl, cfg, bp["cross_norm"], x),
                                    ck, cv, cfg)
    return x + mlp_forward(tsl, bp["mlp"], apply_norm_params(tsl, cfg, bp["mlp_norm"], x),
                           cfg)


def _dec_block(tsl, bp, x, enc, cfg, positions):
    """One decoder block: causal self-attention, the cross K/V projected
    from ``enc`` (inside the block, as the reference's scan body does, so a
    checkpointed block recomputes it) and the cross-attention + MLP.
    Returns (x, (k, v), (ck, cv))."""
    h, kv = attention_forward(tsl, bp["self_attn"],
                              apply_norm_params(tsl, cfg, bp["self_norm"], x), cfg,
                              causal=True, positions=positions)
    ck, cv = project_kv(tsl, bp["cross_attn"], enc, cfg)
    return _cross(tsl, bp, x + h, ck, cv, cfg), kv, (ck, cv)


def _forward(tsl, params, tokens, enc, cfg, *, remat: bool = False):
    """The decoder over the whole token sequence (teacher forcing) against
    ``enc``: (hidden (B,S,D), [(k, v)] self-attention caches, [(ck, cv)]
    cross K/V), per layer. ``remat``: each block under one checkpoint."""
    x = tsl.embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    kvs, cross = [], []
    for bp in _dec_layers(params, cfg):
        x, kv, ckv = run_block(_dec_block, tsl, bp, x, enc, cfg, positions, remat=remat)
        kvs.append(kv)
        cross.append(ckv)
    return x, kvs, cross


def encdec_forward(tsl, params, tokens, cfg, *, audio_embeds, remat: bool = False):
    """Teacher-forced logits (B, S, V) of ``tokens`` over ``audio_embeds``;
    ``remat`` checkpoints every encoder and decoder block (training)."""
    enc = encode(tsl, params, audio_embeds, cfg, remat=remat)
    x, _, _ = _forward(tsl, params, tokens, enc, cfg, remat=remat)
    return _head(tsl, params, cfg, x)


def init_encdec_state(cfg, batch: int, max_len: int, enc_len: int, dtype, device):
    self_shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    cross_shape = (cfg.n_layers, batch, cfg.n_kv_heads, enc_len, cfg.hd)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=device),
        "v": torch.zeros(self_shape, dtype=dtype, device=device),
        # the cross K/V, projected from the encoder at prefill time
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device),
    }


def state_batch_axes(state):
    """Slot axis per leaf: every leaf is (L, B, KH, S, hd), the request at
    axis 1. The cross K/V are sized by enc_len, so a donor only fits a slot
    table built with the same enc_len (``serve/slots.validate_donor``)."""
    return {k: 1 for k in state}


def state_page_axes(state):
    """Token axis per leaf for paged serving: the self-attention caches grow
    a row a token along axis 3 and page; the cross K/V never grow and are
    per-request tails (``None``), snapshotted whole."""
    return {k: 3 if k in ("k", "v") else None for k in state}


def encdec_prefill(tsl, params, tokens, cfg, *, audio_embeds, max_len: int):
    """Whole-prompt prefill; returns (last logits (B, V), decode state). The
    encoder runs once; its cross K/V seed the state."""
    enc = encode(tsl, params, audio_embeds, cfg)
    x, kvs, cross = _forward(tsl, params, tokens, enc, cfg)
    b, s = tokens.shape
    state = init_encdec_state(cfg, b, max_len, enc.shape[1], params["embed"].dtype,
                              params["embed"].device)
    for i, ((k, v), (ck, cv)) in enumerate(zip(kvs, cross)):
        state["k"][i, :, :, :s] = k
        state["v"][i, :, :, :s] = v
        state["cross_k"][i] = ck
        state["cross_v"][i] = cv
    return _head(tsl, params, cfg, x[:, -1:])[:, -1], state


def encdec_prefill_chunk(tsl, params, state, tokens, pos, cfg, *, audio_embeds=None):
    """Continuation prefill of one decoder chunk, in place. On the FIRST chunk
    (``audio_embeds`` given) the encoder runs once and writes each layer's
    cross K/V into the state; later chunks read them. Self-attention writes
    the chunk's K/V at rows [pos, pos+C). Returns (logits (B,C,V), state)."""
    if audio_embeds is not None:
        enc = encode(tsl, params, audio_embeds, cfg)
        for i, bp in enumerate(_dec_layers(params, cfg)):
            ck, cv = project_kv(tsl, bp["cross_attn"], enc, cfg)
            state["cross_k"][i].copy_(ck)
            state["cross_v"][i].copy_(cv)
    x = tsl.embed_lookup(params["embed"], tokens)
    for i, bp in enumerate(_dec_layers(params, cfg)):
        h, _, _ = attention_prefill_chunk(
            tsl, bp["self_attn"], apply_norm_params(tsl, cfg, bp["self_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = _cross(tsl, bp, x + h, state["cross_k"][i], state["cross_v"][i], cfg)
    return _head(tsl, params, cfg, x), state


def encdec_decode_step(tsl, params, state, tokens_t, pos, cfg):
    """tokens_t (B,1) at ``pos`` (an int, or (B,) per-slot positions), in
    place; returns (logits (B,V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens_t)
    for i, bp in enumerate(_dec_layers(params, cfg)):
        h, _, _ = attention_decode(
            tsl, bp["self_attn"], apply_norm_params(tsl, cfg, bp["self_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = _cross(tsl, bp, x + h, state["cross_k"][i], state["cross_v"][i], cfg)
    return _head(tsl, params, cfg, x)[:, 0], state


def encdec_verify_step(tsl, params, state, tokens, pos, cfg):
    """Speculative verify span: causal self-attention over the span at the
    (B,) base rows ``pos`` (its K/V written in place), cross-attention row by
    row against the cross K/V, so any span width scores exactly. Returns
    (logits (B,SV,V), state)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    pos = pos.to(x.device)
    for i, bp in enumerate(_dec_layers(params, cfg)):
        h, _, _ = attention_verify(
            tsl, bp["self_attn"], apply_norm_params(tsl, cfg, bp["self_norm"], x),
            state["k"][i], state["v"][i], pos, cfg)
        x = _cross(tsl, bp, x + h, state["cross_k"][i], state["cross_v"][i], cfg)
    return _head(tsl, params, cfg, x), state


def _paged_span(tsl, params, state, pools, tables, tokens, pos, cfg, span_op):
    """Fused paged decode / verify body (``:245-283``): the decoder's
    self-attention writes and reads its span straight against the page pools
    (``attention_span_paged``; int8 pools with their ``{leaf}__scale`` pools),
    cross-attention reads the cross K/V tails in ``state``. ``kv_len`` = pos
    + C, computed once for every layer. Returns (logits (B,C,V), pools)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    kv_len = (pos + tokens.shape[1]).to(torch.int32)
    int8 = "k__scale" in pools
    for i, bp in enumerate(_dec_layers(params, cfg)):
        scales = {"k_scale": pools["k__scale"][i, 0],
                  "v_scale": pools["v__scale"][i, 0]} if int8 else {}
        h, _, _ = attention_span_paged(
            tsl, bp["self_attn"], apply_norm_params(tsl, cfg, bp["self_norm"], x),
            pools["k"][i, 0], pools["v"][i, 0], tables, pos, cfg, span_op,
            kv_len=kv_len, **scales)
        x = _cross(tsl, bp, x + h, state["cross_k"][i], state["cross_v"][i], cfg)
    return _head(tsl, params, cfg, x), pools


def encdec_decode_step_paged(tsl, params, state, pools, tables, tokens_t, pos, cfg):
    """Fused paged decode: self-attention off the pools through
    ``tsl.attention_decode_paged``, cross-attention against the tails.
    Returns (logits (B,V), state, pools)."""
    logits, pools = _paged_span(tsl, params, state, pools, tables, tokens_t, pos, cfg,
                                tsl.attention_decode_paged)
    return logits[:, 0], state, pools


def encdec_verify_step_paged(tsl, params, state, pools, tables, tokens, pos, cfg):
    """Fused paged verify span (rollback free: rejected rows sit past the
    committed kv_len). Returns (logits (B,SV,V), state, pools)."""
    logits, pools = _paged_span(tsl, params, state, pools, tables, tokens, pos, cfg,
                                tsl.attention_verify_paged)
    return logits, state, pools
