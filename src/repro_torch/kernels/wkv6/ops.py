"""Chunked WKV6: the Finch recurrence as chunk-local products plus a
cross-chunk state scan, plain torch (mirrors ``repro/kernels/wkv6/ops.py``).

Log-space decay bookkeeping keeps the within-chunk decay ratios bounded;
chunk length 32-64 is the numerically comfortable regime (decay ratios are
products of <= L per-channel w in (0, 1]). The intra-chunk term builds a
(B, C, L, L, H, K) float32 tensor: 537 MB for B 4, T 256, L 32 at H = K = 64.
Keep TF32 off on the card: its einsums are float32 matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import wkv6_decode_step, wkv6_scan

_NEG = -60.0   # exp(-60) == 0 in float32; decay logs are negative


def wkv6_chunked(r, k, v, w, u, *, s0=None, chunk: int = 64):
    """Same contract as ``ref.wkv6_scan``. Padding rows (to a whole chunk)
    take w 1 and k 0, so they leave the state exactly as it was."""
    bsz, t, nh, dk = r.shape
    dv = v.shape[-1]
    L = min(chunk, t)
    pad = (-t) % L
    if pad:
        r, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (t + pad) // L

    rf = r.float().reshape(bsz, nc, L, nh, dk)
    kf = k.float().reshape(bsz, nc, L, nh, dk)
    vf = v.float().reshape(bsz, nc, L, nh, dv)
    wf = w.float().reshape(bsz, nc, L, nh, dk)
    uf = u.float()

    lw = torch.log(torch.clamp_min(wf, 1e-20))
    cum = torch.cumsum(lw, dim=2)                    # log prod_{j<=t} w_j  (B,C,L,H,K)
    a_log = cum - lw                                 # log prod_{j<=t-1} w_j

    # intra-chunk, strictly causal s < t: ratio(t, s) = prod_{j=s+1..t-1} w_j
    #   = exp(a_log_t - cum_s)
    seg = a_log[:, :, :, None] - cum[:, :, None]     # (B,C,L,L,H,K)
    strict = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    seg = torch.where(strict[None, None, :, :, None, None], seg, _NEG)
    att = torch.einsum("bcthk,bctshk,bcshk->bctsh", rf, torch.exp(seg), kf)
    y_intra = torch.einsum("bctsh,bcshv->bcthv", att, vf)

    # the diagonal s == t, with the u bonus
    y_diag = torch.einsum("bcthk,hk,bcthk,bcthv->bcthv", rf, uf, kf, vf)

    # inter-chunk: y_inter[t] = (r_t * A_t) @ S_prev, and the chunk's update
    # S_new = diag(prod chunk w) S_prev + sum_s (prod_{j>s} w_j) k_s (x) v_s
    tail = cum[:, :, -1:] - cum                      # log prod_{j=s+1..L} w_j
    chunk_state = torch.einsum("bcshk,bcshk,bcshv->bchkv", torch.exp(tail), kf, vf)
    w_chunk = torch.exp(cum[:, :, -1])               # (B,C,H,K)

    s = torch.zeros((bsz, nh, dk, dv), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = w_chunk[:, c, ..., None] * s + chunk_state[:, c]
    y_inter = torch.einsum("bcthk,bchkv->bcthv", rf * torch.exp(a_log),
                           torch.stack(s_prevs, 1))

    y = (y_intra + y_diag + y_inter).reshape(bsz, nc * L, nh, dv)[:, :t]
    return y.to(r.dtype), s


__all__ = ["wkv6_chunked", "wkv6_scan", "wkv6_decode_step"]
