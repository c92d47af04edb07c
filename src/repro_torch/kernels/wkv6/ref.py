"""The RWKV6 (Finch) WKV recurrence as a naive time scan, plain torch
(mirrors ``repro/kernels/wkv6/ref.py``).

Per head (arXiv:2404.05892, data-dependent decay):

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          S: (B, H, K, V)

with r, k, w (B,T,H,K), v (B,T,H,V), u (H,K) the bonus; w in (0, 1].
"""

from __future__ import annotations

import torch


def wkv6_scan(r, k, v, w, u, *, s0=None):
    """Returns (y (B,T,H,V) in r's dtype, s_final (B,H,K,V) float32); float32
    inside. ``s0`` is read, never written."""
    bsz, t, h, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = (z.float() for z in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = torch.zeros((bsz, h, dk, dv), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]          # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(ys, 1).to(r.dtype), s


def wkv6_decode_step(rt, kt, vt, wt, u, s):
    """One decode step: rt, kt, wt (B,H,K), vt (B,H,V), s (B,H,K,V) float32.
    Returns (y (B,H,V) in rt's dtype, the new state); ``s`` is not written."""
    sf = s.float()
    kv = kt.float()[..., None] * vt.float()[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rt.float(), sf + u.float()[None, :, :, None] * kv)
    return y.to(rt.dtype), wt.float()[..., None] * sf + kv
