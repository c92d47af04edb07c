"""RWKV6 (Finch) block on TSL primitives (mirrors ``repro/nn/rwkv6.py``):
time-mix (WKV with a data-dependent decay through a LoRA on w) and
channel-mix, token shift throughout. Every function takes the generated ops
namespace ``tsl`` explicitly, as ``nn/lm.py`` does.

``n_real`` marks trailing padding rows: an int, or a device tensor of shape
() / (1,) (one count for every sequence) or (B,) (one per sequence), so a
captured step reads it without a host sync. Padding rows take decay 1 and
key 0, so the state after them is exactly the state after the last real
row, and a sequence with ``n_real == 0`` keeps its incoming carries
untouched."""

from __future__ import annotations

import torch

_W_LORA = 64


def dims(cfg):
    """(WKV heads, head size K = V)."""
    k = cfg.rwkv_head_dim
    return cfg.d_model // k, k


def rwkv6_params(cfg, make, lead=()):
    """One block's mixing params (stacked under ``lead``), one
    ``make(kind, shape, **kw)`` per leaf. ``w_base``, the decay bias, is
    float32 whatever the model's dtype, as in the reference."""
    d = cfg.d_model
    nh, hk = dims(cfg)

    def half():
        return make("full", (*lead, d), value=0.5)

    def dense(*shape, **kw):
        return make("dense", (*lead, *shape), **kw)

    return {
        # time mix
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(), "mu_g": half(),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wg": dense(d, d),
        "w_lora_a": dense(d, _W_LORA),
        "w_lora_b": dense(_W_LORA, d, scale=0.01),
        "w_base": make("full", (*lead, d), value=-6.0, leaf_dtype=torch.float32),
        "u_bonus": dense(nh, hk),
        "wo": dense(d, d),
        "ln_x_w": make("ones", (*lead, d)),
        # channel mix
        "cm_mu_k": half(), "cm_mu_r": half(),
        "cm_wk": dense(d, cfg.d_ff),
        "cm_wv": dense(cfg.d_ff, d),
        "cm_wr": dense(d, d),
    }


def _decay(tsl, p, xw):
    """Data-dependent per-channel decay w_t in (0, 1): exp(-exp(base + lora)),
    float32."""
    lora = tsl.matmul(tsl.matmul(xw, p["w_lora_a"]), p["w_lora_b"])
    return torch.exp(-torch.exp(p["w_base"] + lora.float()))


def _n_real_col(n_real, device) -> torch.Tensor:
    """``n_real`` as a (B or 1, 1) int64 device tensor."""
    return torch.as_tensor(n_real, device=device).reshape(-1, 1)


def _last_real(x, n_real, prev):
    """x (B,T,D) -> the row at n_real - 1, (B,D): the token-shift carry for
    the next chunk is the last REAL row's normed activation, not a padding
    row's. An all-padding sequence (n_real 0) keeps the incoming carry
    ``prev`` (zeros on a fresh start, what token_shift pads with)."""
    if n_real is None:
        return x[:, -1]
    nr = _n_real_col(n_real, x.device).expand(x.shape[0], 1)      # (B, 1)
    idx = (nr.clamp_min(1) - 1)[:, :, None].expand(-1, 1, x.shape[2])
    last = x.gather(1, idx)[:, 0]
    keep = torch.zeros_like(last) if prev is None else prev.to(last.dtype)
    return torch.where(nr > 0, last, keep)


def time_mix_forward(tsl, p, x, cfg, *, prev_tok=None, s0=None, n_real=None):
    """x (B,T,D) -> (y, (last_tok, s_final)). Positions >= ``n_real`` are
    padding: their WKV update is the identity (decay 1, key 0), so
    ``s_final`` is exactly the state after the last real token, and
    ``last_tok`` is the row at n_real - 1. Padding rows of y are garbage the
    caller discards (causality: they never feed a real position). Reads
    ``prev_tok`` and ``s0``, writes neither."""
    bsz, t, d = x.shape
    nh, hk = dims(cfg)
    xr, xk, xv, xw, xg = (tsl.token_shift(x, p[f"mu_{n}"], prev=prev_tok)
                          for n in "rkvwg")
    r = tsl.matmul(xr, p["wr"]).reshape(bsz, t, nh, hk)
    k = tsl.matmul(xk, p["wk"]).reshape(bsz, t, nh, hk)
    v = tsl.matmul(xv, p["wv"]).reshape(bsz, t, nh, hk)
    # the float32 decay is cast to the activations' dtype before the scan,
    # as the reference does (in bf16 exp(-exp(-6)) rounds to 0.99609 or 1)
    w = _decay(tsl, p, xw).reshape(bsz, t, nh, hk).to(x.dtype)
    if n_real is not None:
        nr = _n_real_col(n_real, x.device)
        valid = (torch.arange(t, device=x.device)[None, :] < nr)[:, :, None, None]
        w = torch.where(valid, w, torch.ones_like(w))
        k = torch.where(valid, k, torch.zeros_like(k))
    g = tsl.silu(tsl.matmul(xg, p["wg"]))
    y, s_final = tsl.wkv6_scan(r, k, v, w, p["u_bonus"], s0=s0)
    y = tsl.rmsnorm(y.reshape(bsz, t, d), p["ln_x_w"], eps=cfg.norm_eps) * g
    return tsl.matmul(y, p["wo"]), (_last_real(x, n_real, prev_tok), s_final)


def time_mix_decode(tsl, p, x_t, cfg, prev_tok, s):
    """x_t (B,1,D); prev_tok (B,D); s (B,H,K,V) float32 -> (y, new carry,
    new state); reads ``prev_tok`` and ``s``, writes neither."""
    bsz, _, d = x_t.shape
    nh, hk = dims(cfg)
    xr, xk, xv, xw, xg = (tsl.token_shift(x_t, p[f"mu_{n}"], prev=prev_tok)
                          for n in "rkvwg")
    r = tsl.matmul(xr, p["wr"]).reshape(bsz, nh, hk)
    k = tsl.matmul(xk, p["wk"]).reshape(bsz, nh, hk)
    v = tsl.matmul(xv, p["wv"]).reshape(bsz, nh, hk)
    w = _decay(tsl, p, xw).reshape(bsz, nh, hk).to(x_t.dtype)
    g = tsl.silu(tsl.matmul(xg, p["wg"]))
    yt, s = tsl.wkv6_decode(r, k, v, w, p["u_bonus"], s)
    yt = tsl.rmsnorm(yt.reshape(bsz, 1, d), p["ln_x_w"], eps=cfg.norm_eps) * g
    return tsl.matmul(yt, p["wo"]), x_t[:, -1], s


def channel_mix_forward(tsl, p, x, cfg, *, prev_tok=None, n_real=None):
    """x (B,T,D) -> (y, last_tok): sigmoid(r) * (relu(k)^2 @ W_v)."""
    xk = tsl.token_shift(x, p["cm_mu_k"], prev=prev_tok)
    xr = tsl.token_shift(x, p["cm_mu_r"], prev=prev_tok)
    k = torch.relu(tsl.matmul(xk, p["cm_wk"])).square()
    out = tsl.sigmoid(tsl.matmul(xr, p["cm_wr"])) * tsl.matmul(k, p["cm_wv"])
    return out, _last_real(x, n_real, prev_tok)
