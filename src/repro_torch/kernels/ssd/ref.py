"""The Mamba2 SSD recurrence as a naive time scan, plain torch (mirrors
``repro/kernels/ssd/ref.py``).

State-space duality recurrence (Mamba2, arXiv:2405.21060), scalar-per-head
decay:

    h_t = a_t * h_{t-1} + x_t ⊗ b_t          h: (B, H, P, N)
    y_t = h_t @ c_t                           y: (B, H, P)

with x (B,T,H,P), a (B,T,H) in (0,1], b,c (B,T,N) (shared across heads).
"""

from __future__ import annotations

import torch


def ssd_scan(x, a, b, c, *, h0=None):
    """Returns (y (B,T,H,P) in x's dtype, h_final (B,H,P,N) float32); float32
    inside. ``h0`` is read, never written."""
    bsz, t, nh, p = x.shape
    n = b.shape[-1]
    xf, af, bf, cf = (z.float() for z in (x, a, b, c))
    h = torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for i in range(t):
        h = af[:, i, :, None, None] * h + xf[:, i, :, :, None] * bf[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, i]))
    y = torch.stack(ys, 1) if ys else torch.zeros((bsz, 0, nh, p), device=x.device)
    return y.to(x.dtype), h


def ssd_decode_step(xt, at, bt, ct, h):
    """One decode step: xt (B,H,P), at (B,H), bt/ct (B,N), h (B,H,P,N).
    Returns (y (B,H,P) in xt's dtype, the new float32 state); ``h`` is not
    written."""
    hnew = at.float()[:, :, None, None] * h.float() \
        + xt.float()[..., None] * bt.float()[:, None, None, :]
    yt = torch.einsum("bhpn,bn->bhp", hnew, ct.float())
    return yt.to(xt.dtype), hnew
