"""zamba2 hybrid LM: a Mamba2 backbone plus ONE shared attention block
applied after every ``attn_every`` layers (mirrors ``repro/nn/zamba.py``).

Structure: n_groups = n_layers // attn_every groups of [attn_every Mamba2
layers + the shared attention block], then a remainder stack. Group params
are stacked (G, k, ...) and the remainder's (rem, ...), the reference's
layout, so its params load 1:1; Python loops over the groups and layers
replace its two-level ``lax.scan``. The shared attention block's weights are
one copy, applied G times.

Training: ``zamba_forward(..., remat=True)`` wraps each group (its k Mamba2
layers and the shared block's application) and each remainder layer in one
``lm.run_block`` checkpoint, as the reference wraps its group and remainder
scan bodies in ``jax.checkpoint``. The shared block's gradient is the sum
over its G applications (autograd adds each application's into the one
leaf). No op on the training path writes in place: the in-place writes
below are the serving paths'.

The decode state holds both kinds of state: the Mamba2 tails (``h`` (G, k,
B, H, P, N) float32, ``conv`` (G, k, B, KW-1, d_inner), and ``h_rest`` /
``conv_rest`` for the remainder), fixed size per request, and the shared
block's KV caches (``attn_k`` / ``attn_v`` (G, B, KH, S, hd)), one per
application, which grow with the sequence and page in paged serving.

Unlike the reference, state is written IN PLACE (each layer's slice once its
block has read it), and the page pools by the fused paged steps. The verify
steps leave the tails as they were (a scan state cannot be truncated: the
engine replays the accepted prefix through the commit), while their span's
K/V rows land in the caches or pools in place: the commit's replay rewrites
the accepted rows with the same values, and rejected rows lie past the
committed fill, where the kv_len mask hides them until they are
overwritten. The reference discards the verify's K/V writes instead; the
committed state is the same."""

from __future__ import annotations

import torch

from .attention import (attention_decode, attention_forward, attention_prefill_chunk,
                        attention_span_paged, attention_verify, init_attention)
from .common import apply_norm_params, init_norm
from .lm import lm_head, run_block, unstack_layers
from .mamba2 import dims as m2_dims
from .mamba2 import mamba2_decode, mamba2_forward, mamba2_params


def layout(cfg) -> tuple[int, int, int]:
    """(n_groups, group_size, remainder)."""
    k = cfg.attn_every
    g = cfg.n_layers // k
    return g, k, cfg.n_layers - g * k


def zamba_params(cfg, make):
    """The parameter tree of ``cfg``, one ``make(kind, shape, **kw)`` per leaf."""
    g, k, rem = layout(cfg)
    params = {
        "embed": make("embed", (cfg.padded_vocab, cfg.d_model)),
        "groups": {"norm": init_norm(cfg, make, (g, k)),
                   "mamba": mamba2_params(cfg, make, (g, k))},
        "shared_attn_norm": init_norm(cfg, make),
        "shared_attn": init_attention(cfg, make),
        "final_norm": init_norm(cfg, make),
        "head": make("dense", (cfg.d_model, cfg.padded_vocab)),
    }
    if rem:
        params["rest"] = {"norm": init_norm(cfg, make, (rem,)),
                          "mamba": mamba2_params(cfg, make, (rem,))}
    return params


def _groups(params, cfg) -> list[list[dict]]:
    """Each group's list of its k Mamba2 blocks' params (views, no copy)."""
    g, k, _ = layout(cfg)
    return [unstack_layers(gp, k) for gp in unstack_layers(params["groups"], g)]


def _rest(params, cfg) -> list[dict]:
    _, _, rem = layout(cfg)
    return unstack_layers(params["rest"], rem) if rem else []


def _shared_in(tsl, params, cfg, x):
    return apply_norm_params(tsl, cfg, params["shared_attn_norm"], x)


def _head(tsl, params, cfg, x):
    return lm_head(tsl, params, apply_norm_params(tsl, cfg, params["final_norm"], x), cfg)


def _mamba_residual(tsl, bp, x, cfg):
    """x + one Mamba2 block of its normed x (from a fresh state)."""
    return x + mamba2_forward(tsl, bp["mamba"], apply_norm_params(tsl, cfg, bp["norm"], x),
                              cfg)[0]


def zamba_forward(tsl, params, tokens, cfg, *, remat: bool = False):
    """tokens (B,S) -> logits (B,S,V). ``remat``: recompute each group's
    and each remainder layer's activations in the backward (one
    non-reentrant checkpoint each, ``lm.run_block``)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def group(x, blocks):
        for bp in blocks:
            x = _mamba_residual(tsl, bp, x, cfg)
        h, _ = attention_forward(tsl, params["shared_attn"], _shared_in(tsl, params, cfg, x),
                                 cfg, causal=True, positions=positions)
        return x + h

    for blocks in _groups(params, cfg):
        x = run_block(group, x, blocks, remat=remat)
    for bp in _rest(params, cfg):
        x = run_block(_mamba_residual, tsl, bp, x, cfg, remat=remat)
    return _head(tsl, params, cfg, x)


def init_zamba_state(cfg, batch: int, max_len: int, dtype, device):
    g, k, rem = layout(cfg)
    d_in, nh, n, p_dim = m2_dims(cfg)
    kw = cfg.conv_width

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    state = {
        "h": zeros((g, k, batch, nh, p_dim, n), torch.float32),
        "conv": zeros((g, k, batch, kw - 1, d_in)),
        "attn_k": zeros((g, batch, cfg.n_kv_heads, max_len, cfg.hd)),
        "attn_v": zeros((g, batch, cfg.n_kv_heads, max_len, cfg.hd)),
    }
    if rem:
        state["h_rest"] = zeros((rem, batch, nh, p_dim, n), torch.float32)
        state["conv_rest"] = zeros((rem, batch, kw - 1, d_in))
    return state


def state_batch_axes(state):
    """Slot-axis position per state leaf: the grouped SSM / conv leaves are
    (G, k, B, ...), the request axis at 2; the shared block's caches (G, B,
    KH, S, hd) and the remainder stack (rem, B, ...) carry it at 1."""
    return {k: 2 if k in ("h", "conv") else 1 for k in state}


def state_page_axes(state):
    """Token axis per leaf for paged serving: only the shared block's KV
    caches (G, B, KH, S, hd) grow per token (axis 3); the SSM / conv leaves
    are fixed-size recurrent state, ``None``: the per-request TAIL the paged
    store snapshots whole (and shares at prefix boundaries)."""
    return {k: 3 if k in ("attn_k", "attn_v") else None for k in state}


def _tail_slots(state, cfg):
    """[(group index or None, (h, conv) slices)] in layer order: each group's
    k layers, then the remainder's."""
    g, k, rem = layout(cfg)
    out = [(gi, (state["h"][gi, j], state["conv"][gi, j]))
           for gi in range(g) for j in range(k)]
    return out + [(None, (state["h_rest"][i], state["conv_rest"][i])) for i in range(rem)]


def _layers(tsl, params, state, x, cfg, mamba, attend, *, write=True):
    """x through every Mamba2 layer, each by ``mamba(block params, normed x,
    h, conv) -> (y, h_new, conv_new)`` from its carried tail (written in
    place with ``write``), and after each group's k layers through the
    shared attention block, ``attend(group index, normed x)``. Returns x
    after the last layer."""
    _, k, _ = layout(cfg)
    blocks = [bp for group in _groups(params, cfg) for bp in group] + _rest(params, cfg)
    for i, (bp, (gi, (h, conv))) in enumerate(zip(blocks, _tail_slots(state, cfg))):
        y, h_new, conv_new = mamba(bp["mamba"], apply_norm_params(tsl, cfg, bp["norm"], x),
                                   h, conv)
        if write:
            h.copy_(h_new)
            conv.copy_(conv_new)
        x = x + y
        if gi is not None and (i + 1) % k == 0:
            x = x + attend(gi, _shared_in(tsl, params, cfg, x))
    return x


def _chunk_layers(tsl, params, state, x, cfg, attend, *, n_real=None, write=True):
    """:func:`_layers` over a chunk x (B,C,D) by ``mamba2_forward``, the
    rows past ``n_real`` padding."""
    def mamba(p, xn, h0, conv_prev):
        y, (h_f, conv_t) = mamba2_forward(tsl, p, xn, cfg, h0=h0, conv_prev=conv_prev,
                                          n_real=n_real)
        return y, h_f, conv_t
    return _layers(tsl, params, state, x, cfg, mamba, attend, write=write)


def _decode_layers(tsl, params, state, x, cfg, attend):
    """:func:`_layers` over one token x (B,1,D) by ``mamba2_decode``."""
    def mamba(p, xn, h, conv):
        return mamba2_decode(tsl, p, xn, cfg, h, conv)
    return _layers(tsl, params, state, x, cfg, mamba, attend)


def zamba_prefill(tsl, params, tokens, cfg, *, max_len: int):
    """Whole-prompt prefill collecting the SSM states, conv tails and the
    shared block's KV caches: (last logits (B,V), a fresh decode state)."""
    b, s = tokens.shape
    x = tsl.embed_lookup(params["embed"], tokens)
    state = init_zamba_state(cfg, b, max_len, params["embed"].dtype, x.device)
    positions = torch.arange(s, device=x.device)

    def attend(gi, xn):
        h, (k, v) = attention_forward(tsl, params["shared_attn"], xn, cfg, causal=True,
                                      positions=positions)
        state["attn_k"][gi, :, :, :s] = k
        state["attn_v"][gi, :, :, :s] = v
        return h

    x = _chunk_layers(tsl, params, state, x, cfg, attend)
    # the kernels take contiguous rows
    return _head(tsl, params, cfg, x[:, -1:].contiguous())[:, 0], state


def zamba_prefill_chunk(tsl, params, state, tokens, pos, cfg, *, n_real=None,
                        attend=attention_prefill_chunk):
    """Continuation prefill of one chunk into a live hybrid decode state, in
    place: the mamba layers carry (h, conv) forward exactly (padding rows
    past ``n_real`` are identity updates, see ``nn/mamba2.py``), the shared
    block writes the chunk's K/V at rows [pos, pos+C) of each group's cache.
    ``pos`` / ``n_real`` may be (B,) per-slot device tensors (the commit's
    ragged replay over the slot table); ``attend`` swaps the shared block's
    span op (the verify path's ``attention_verify``). Returns
    (logits (B,C,V), state)."""
    return _chunk(tsl, params, state, tokens, pos, cfg, attend, n_real=n_real), state


def _chunk(tsl, params, state, tokens, pos, cfg, attend, *, n_real=None, write=True):
    x = tsl.embed_lookup(params["embed"], tokens)

    def shared(gi, xn):
        return attend(tsl, params["shared_attn"], xn, state["attn_k"][gi],
                      state["attn_v"][gi], pos, cfg)[0]

    x = _chunk_layers(tsl, params, state, x, cfg, shared, n_real=n_real, write=write)
    return _head(tsl, params, cfg, x)


def zamba_verify_step(tsl, params, state, tokens, pos, cfg):
    """Speculative verify span, PURE scoring for the tails: tokens (B,SV)
    scored from the carried state, the shared block through
    ``attention_verify``. The tails are not written (the engine replays the
    accepted prefix through :func:`zamba_prefill_chunk` with a per-slot
    ``n_real``, the commit); the span's K/V rows are, in place (see the
    module's docstring). Returns (logits (B,SV,V), state)."""
    return _chunk(tsl, params, state, tokens, pos, cfg, attention_verify, write=False), state


def zamba_decode_step(tsl, params, state, tokens_t, pos, cfg):
    """tokens_t (B,1) -> (logits (B,V), state updated in place)."""
    x = tsl.embed_lookup(params["embed"], tokens_t)

    def shared(gi, xn):
        return attention_decode(tsl, params["shared_attn"], xn, state["attn_k"][gi],
                                state["attn_v"][gi], pos, cfg)[0]

    return _head(tsl, params, cfg, _decode_layers(tsl, params, state, x, cfg, shared))[:, 0], \
        state


def _paged_attend(tsl, params, pools, tables, pos, cfg, span_op, c):
    """The shared block straight off the page pools: group gi's slice of the
    (G, 1, KH, n_pages, page, hd) pools (int8 pools with their scale pools
    beside them), ``kv_len`` = pos + c computed once for every group."""
    kv_len = (pos + c).to(torch.int32)
    int8 = "attn_k__scale" in pools

    def attend(gi, xn):
        scales = {"k_scale": pools["attn_k__scale"][gi, 0],
                  "v_scale": pools["attn_v__scale"][gi, 0]} if int8 else {}
        return attention_span_paged(tsl, params["shared_attn"], xn, pools["attn_k"][gi, 0],
                                    pools["attn_v"][gi, 0], tables, pos, cfg, span_op,
                                    kv_len=kv_len, **scales)[0]
    return attend


def zamba_decode_step_paged(tsl, params, state, pools, tables, tokens_t, pos, cfg):
    """Fused paged decode: the mamba layers update the TAIL state exactly as
    :func:`zamba_decode_step` does (the same ``mamba2_decode``), and the
    shared block decodes straight off the page pools through
    ``tsl.attention_decode_paged``. Returns (logits (B,V), state, pools)."""
    x = tsl.embed_lookup(params["embed"], tokens_t)
    attend = _paged_attend(tsl, params, pools, tables, pos, cfg, tsl.attention_decode_paged, 1)
    return _head(tsl, params, cfg, _decode_layers(tsl, params, state, x, cfg, attend))[:, 0], \
        state, pools


def _paged_chunk(tsl, params, state, pools, tables, tokens, pos, cfg, *, n_real=None,
                 write=True):
    """Fused-paged analogue of :func:`zamba_prefill_chunk` (the reference's
    ``_zamba_paged_chunk``): the mamba layers carry the tails, the shared
    block writes and reads its span straight against the pools through
    ``tsl.attention_verify_paged``. Returns the logits (B,C,V)."""
    x = tsl.embed_lookup(params["embed"], tokens)
    attend = _paged_attend(tsl, params, pools, tables, pos, cfg, tsl.attention_verify_paged,
                           tokens.shape[1])
    return _head(tsl, params, cfg, _chunk_layers(tsl, params, state, x, cfg, attend,
                                                 n_real=n_real, write=write))


def zamba_verify_step_paged(tsl, params, state, pools, tables, tokens, pos, cfg):
    """Fused paged verify span, PURE scoring for the tails: they are not
    written (the engine replays the accepted prefix through
    :func:`zamba_verify_commit_paged`), while the span's K/V rows land in
    the pools — the replay's writes are idempotent over them and rejected
    rows sit past the committed kv_len. Returns (logits (B,SV,V), state,
    pools)."""
    return _paged_chunk(tsl, params, state, pools, tables, tokens, pos, cfg, write=False), \
        state, pools


def zamba_verify_commit_paged(tsl, params, state, pools, tables, tokens, pos, cfg, n_commit):
    """The commit replay on the pools: the span re-run with per-slot
    ``n_commit`` (B,) real rows (0: the slot's tails exactly as they were),
    tails and pools written in place. Returns (state, pools)."""
    _paged_chunk(tsl, params, state, pools, tables, tokens, pos, cfg, n_real=n_commit)
    return state, pools
