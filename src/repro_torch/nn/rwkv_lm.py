"""RWKV6 LM (Finch): an attention-free stack of time-mix + channel-mix
blocks (mirrors ``repro/nn/rwkv_lm.py``).

Token-shift carries are stored in NORMED space (the value token_shift
actually mixes), so forward-collected states and decode-carried states
agree. The decode state is {tm_prev, cm_prev (L, B, d) in the model dtype,
s (L, B, H, K, V) float32}: fixed size per request, nothing grows with the
sequence. Layer params stay stacked along L, as in ``nn/lm.py``.

Unlike the reference, prefill_chunk, decode_step and the commit update the
state IN PLACE (each layer's slice written once its mixes have read it);
verify_step writes nothing."""

from __future__ import annotations

import torch

from .common import apply_norm_params, init_norm
from .lm import lm_head, unstack_layers
from .rwkv6 import (channel_mix_forward, dims, rwkv6_params, time_mix_decode,
                    time_mix_forward)

def rwkv_params(cfg, make):
    """The parameter tree of ``cfg``, one ``make(kind, shape, **kw)`` per leaf."""
    L = (cfg.n_layers,)
    return {
        "embed": make("embed", (cfg.padded_vocab, cfg.d_model)),
        "ln_in": init_norm(cfg, make),
        "blocks": {
            "ln1": init_norm(cfg, make, L),
            "ln2": init_norm(cfg, make, L),
            "mix": rwkv6_params(cfg, make, L),
        },
        "final_norm": init_norm(cfg, make),
        "head": make("dense", (cfg.d_model, cfg.padded_vocab)),
    }


def rwkv_forward(tsl, params, tokens, cfg, *, state=None, write: bool = False,
                 last_only: bool = False, n_real=None):
    """tokens (B,S) -> logits (B,S,V) (B,1,V with ``last_only``).

    ``state`` (None: a fresh start) carries the recurrence in; ``write``
    updates it in place to the state after the last REAL token. ``n_real``
    (see ``nn/rwkv6.py``): positions >= n_real are padding, their recurrent
    updates skipped exactly; their logits rows are garbage the caller
    discards."""
    x = tsl.embed_lookup(params["embed"], tokens)
    x = apply_norm_params(tsl, cfg, params["ln_in"], x)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        tm_prev, cm_prev, s0 = (None, None, None) if state is None else \
            (state["tm_prev"][i], state["cm_prev"][i], state["s"][i])
        y, (tm_last, s_final) = time_mix_forward(
            tsl, bp["mix"], apply_norm_params(tsl, cfg, bp["ln1"], x), cfg,
            prev_tok=tm_prev, s0=s0, n_real=n_real)
        x = x + y
        y, cm_last = channel_mix_forward(
            tsl, bp["mix"], apply_norm_params(tsl, cfg, bp["ln2"], x), cfg,
            prev_tok=cm_prev, n_real=n_real)
        x = x + y
        if write:
            state["tm_prev"][i].copy_(tm_last)
            state["cm_prev"][i].copy_(cm_last)
            state["s"][i].copy_(s_final)
    if last_only:
        x = x[:, -1:]
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg)


def init_rwkv_state(cfg, batch: int, dtype, device):
    nh, hk = dims(cfg)
    return {
        "tm_prev": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dtype, device=device),
        "cm_prev": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dtype, device=device),
        "s": torch.zeros((cfg.n_layers, batch, nh, hk, hk), dtype=torch.float32,
                         device=device),
    }


def state_batch_axes(state):
    """Slot-axis position per state leaf: every recurrent leaf is (L, B, ...),
    the request axis at 1."""
    return {k: 1 for k in state}


def state_page_axes(state):
    """Token axis per leaf for paged serving: none grows with the sequence,
    so nothing pages (all ``None``). The paged store still gives rwkv
    residency accounting (tail bytes per request) and prefix sharing (a tail
    snapshot at a chunk boundary is the whole prefix state)."""
    return {k: None for k in state}


def rwkv_prefill(tsl, params, tokens, cfg):
    """Whole-prompt prefill: (last logits (B,V), a fresh decode state)."""
    state = init_rwkv_state(cfg, tokens.shape[0], params["embed"].dtype,
                            params["embed"].device)
    logits = rwkv_forward(tsl, params, tokens, cfg, state=state, write=True,
                          last_only=True)
    return logits[:, -1], state


def rwkv_prefill_chunk(tsl, params, state, tokens, cfg, *, n_real=None):
    """Continuation prefill of one chunk: ``tokens`` (B,C) consumed into the
    carried state in place (zeros == a fresh start), the first ``n_real``
    rows real. Position-free. Returns (logits (B,C,V), state)."""
    logits = rwkv_forward(tsl, params, tokens, cfg, state=state, write=True,
                          n_real=n_real)
    return logits, state


def rwkv_verify_step(tsl, params, state, tokens, cfg):
    """Speculative verify span, pure scoring: tokens (B,SV), each slot's
    pending token and drafts, scored against the carried state WITHOUT
    committing it (nothing is written). A scan state cannot be truncated, so
    rollback is a checkpoint: the engine replays the accepted prefix through
    :func:`rwkv_prefill_chunk` with a per-slot ``n_real`` (the commit).
    Row j of the logits is independent of rows > j. Returns
    (logits (B,SV,V), state unchanged)."""
    return rwkv_forward(tsl, params, tokens, cfg, state=state), state


def rwkv_decode_step(tsl, params, state, tokens_t, cfg):
    """tokens_t (B,1) -> (logits (B,V), state updated in place)."""
    x = tsl.embed_lookup(params["embed"], tokens_t)
    x = apply_norm_params(tsl, cfg, params["ln_in"], x)
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        y, tm_new, s_new = time_mix_decode(
            tsl, bp["mix"], apply_norm_params(tsl, cfg, bp["ln1"], x), cfg,
            state["tm_prev"][i], state["s"][i])
        x = x + y
        y, cm_new = channel_mix_forward(
            tsl, bp["mix"], apply_norm_params(tsl, cfg, bp["ln2"], x), cfg,
            prev_tok=state["cm_prev"][i])
        x = x + y
        state["tm_prev"][i].copy_(tm_new)
        state["cm_prev"][i].copy_(cm_new)
        state["s"][i].copy_(s_new)
    x = apply_norm_params(tsl, cfg, params["final_norm"], x)
    return lm_head(tsl, params, x, cfg)[:, 0], state
