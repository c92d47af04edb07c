"""Mamba2 block (zamba2's backbone) on TSL primitives (mirrors
``repro/nn/mamba2.py``). Every function takes the generated ops namespace
``tsl`` explicitly, as ``nn/lm.py`` does.

Block: in_proj -> [z | x | B | C | dt] -> causal_conv1d(x) -> SSD -> gated
rmsnorm -> out_proj. Scalar-per-head decay a = exp(-exp(A_log)·softplus(dt)),
input scaled by dt (the SSD discretization). The decay is cast to the
activations' dtype before the scan, as the reference does.

``n_real`` marks trailing padding rows: an int, or a device tensor of shape
() / (1,) (one count for every sequence) or (B,) (one per sequence), so a
captured step reads it without a host sync. Padding rows take decay 1 and
input 0, so the SSM state after them is exactly the state after the last
real row, and the conv tail ends at the last real row."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dims(cfg):
    """(d_inner, SSD heads, state size N, head size P)."""
    d_in = cfg.d_inner_mult * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim


def mamba2_params(cfg, make, lead=()):
    """One block's params (stacked under ``lead``), one ``make(kind, shape,
    **kw)`` per leaf. ``A_log``, ``dt_bias`` and ``D_skip`` are float32
    whatever the model's dtype, as in the reference."""
    d = cfg.d_model
    d_in, nh, n, _ = dims(cfg)
    f32 = {"leaf_dtype": torch.float32}
    return {
        "in_proj": make("dense", (*lead, d, 2 * d_in + 2 * n + nh)),
        "conv_w": make("dense", (*lead, cfg.conv_width, d_in), scale=0.5),
        "A_log": make("zeros", (*lead, nh), **f32),
        "dt_bias": make("zeros", (*lead, nh), **f32),
        "D_skip": make("ones", (*lead, nh), **f32),
        "gate_norm_w": make("ones", (*lead, d_in)),
        "out_proj": make("dense", (*lead, d_in, d)),
    }


def _split_proj(zxbcdt, cfg):
    d_in, _, n, _ = dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in],
            zxbcdt[..., 2 * d_in:2 * d_in + n], zxbcdt[..., 2 * d_in + n:2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


def _discretize(p, dt_raw, x, cfg):
    """-> (a (B,T,H) decay in x's dtype, x_scaled (B,T,H,P), xh (B,T,H,P))."""
    _, nh, _, p_dim = dims(cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    xh = x.reshape(*x.shape[:-1], nh, p_dim)
    x_scaled = (xh.float() * dt[..., None]).to(x.dtype)
    return a.to(x.dtype), x_scaled, xh


def _n_real_col(n_real, bsz: int, device) -> torch.Tensor:
    """``n_real`` as a (B, 1) int64 device tensor."""
    return torch.as_tensor(n_real, device=device).reshape(-1, 1).expand(bsz, 1)


def mamba2_forward(tsl, p, x_seq, cfg, *, h0=None, conv_prev=None, n_real=None):
    """x_seq (B,T,D) -> (y (B,T,D), (h_final (B,H,P,N) float32, conv_tail
    (B,KW-1,d_in))). ``h0`` / ``conv_prev`` continue a prior chunk (None:
    a fresh start, zeros); both are read, never written. Positions >=
    ``n_real`` are padding: their SSD update is the identity (decay 1,
    input 0), so ``h_final`` is exactly the state after the last real token,
    and the conv tail is the window of KW-1 rows ending at the last real row
    (leading rows of ``conv_prev`` where fewer than KW-1 are real). Padding
    rows of y are garbage the caller discards."""
    bsz, t, _ = x_seq.shape
    d_in, _, _, _ = dims(cfg)
    kw = cfg.conv_width
    z, xr, b, c, dt_raw = _split_proj(tsl.matmul(x_seq, p["in_proj"]), cfg)
    if kw > 1:
        if conv_prev is None:
            conv_prev = torch.zeros((bsz, kw - 1, d_in), dtype=xr.dtype, device=xr.device)
        xr_in = torch.cat([conv_prev.to(xr.dtype), xr], dim=1)
        xc = tsl.causal_conv1d(xr_in, p["conv_w"])[:, kw - 1:]
    else:
        xr_in = xr
        xc = tsl.causal_conv1d(xr, p["conv_w"])
    xc = tsl.silu(xc)
    a, x_scaled, xh = _discretize(p, dt_raw, xc, cfg)
    if n_real is not None:
        nr = _n_real_col(n_real, bsz, x_seq.device)
        valid = torch.arange(t, device=x_seq.device)[None, :] < nr         # (B, T)
        a = torch.where(valid[:, :, None], a, torch.ones_like(a))
        x_scaled = torch.where(valid[:, :, None, None], x_scaled, torch.zeros_like(x_scaled))
    y, h_final = tsl.ssd_scan(x_scaled, a, b, c, h0=h0)
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = tsl.rmsnorm(y.reshape(bsz, t, d_in) * tsl.silu(z), p["gate_norm_w"],
                    eps=cfg.norm_eps)
    conv_tail = None
    if kw > 1:
        # the KW-1 rows of xr_in ending at its row (KW-1) + n_real - 1: rows
        # [n_real, n_real + KW - 1), per sequence
        end = torch.full((bsz, 1), t, device=x_seq.device) if n_real is None \
            else _n_real_col(n_real, bsz, x_seq.device)
        idx = end + torch.arange(kw - 1, device=x_seq.device)[None, :]    # (B, KW-1)
        conv_tail = xr_in.gather(1, idx[:, :, None].expand(-1, -1, d_in))
    return tsl.matmul(y, p["out_proj"]), (h_final, conv_tail)


def mamba2_decode(tsl, p, x_t, cfg, h, conv_cache):
    """One step. x_t (B,1,D); h (B,H,P,N) float32; conv_cache (B,KW-1,d_in).
    Returns (y (B,1,D), new h, new conv window); reads ``h`` and
    ``conv_cache``, writes neither."""
    bsz = x_t.shape[0]
    d_in, _, _, _ = dims(cfg)
    z, xr, b, c, dt_raw = _split_proj(tsl.matmul(x_t, p["in_proj"]), cfg)
    window = torch.cat([conv_cache, xr], dim=1)                        # (B,KW,d_in)
    xc = (window.float() * p["conv_w"].float()[None]).sum(1, keepdim=True)
    xc = tsl.silu(xc.to(x_t.dtype))
    a, x_scaled, xh = _discretize(p, dt_raw, xc, cfg)
    yt, h = tsl.ssd_decode(x_scaled[:, 0], a[:, 0], b[:, 0], c[:, 0], h)
    yt = yt + p["D_skip"][None, :, None].to(yt.dtype) * xh[:, 0]
    yt = tsl.rmsnorm(yt.reshape(bsz, 1, d_in) * tsl.silu(z), p["gate_norm_w"],
                     eps=cfg.norm_eps)
    return tsl.matmul(yt, p["out_proj"]), h, window[:, 1:]
