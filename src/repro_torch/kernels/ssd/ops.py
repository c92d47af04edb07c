"""Chunked SSD (Mamba2's state-space-duality algorithm), plain torch
(mirrors ``repro/kernels/ssd/ops.py``).

The chunk-local quadratic part is two dense (L×L)·(L×·) products, and the
cross-chunk recurrence a scan over chunk states — a "linear attention with
decay" decomposition:

    y = (M ⊙ (C Bᵀ)) X  +  (decay · C) h_prev
    M[t,s] = prod_{j=s+1..t} a_j  (causal, log-space cumulative sums)

float32 inside, as in the reference: ``log(max(a, 1e-20))``, the causal mask
filled with -1e30 before the exp, and padding to a whole chunk with a = 1
(and x, b, c = 0), which leaves the state exactly as it was. Keep TF32 off on
the card: the einsums are float32 matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import ssd_decode_step, ssd_scan

_NEG = -1e30


def ssd_chunked(x, a, b, c, *, h0=None, chunk: int = 128):
    """Same contract as ``ref.ssd_scan``, computed chunk-parallel.

    x (B,T,H,P), a (B,T,H), b,c (B,T,N) -> y (B,T,H,P), h_final (B,H,P,N)."""
    bsz, t, nh, p = x.shape
    n = b.shape[-1]
    L = min(chunk, t)
    pad = (-t) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (t + pad) // L

    xf = x.float().reshape(bsz, nc, L, nh, p)
    af = a.float().reshape(bsz, nc, L, nh)
    bf = b.float().reshape(bsz, nc, L, n)
    cf = c.float().reshape(bsz, nc, L, n)

    la = torch.log(torch.clamp_min(af, 1e-20))          # (B,C,L,H)
    cum = torch.cumsum(la, dim=2)                        # log prod_{j<=t} a_j
    # M[t,s] = exp(cum_t - cum_s) for s <= t, else 0
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal[None, None, :, :, None], seg, _NEG)
    m = torch.exp(seg)

    # intra-chunk: y_intra = (M ⊙ (C Bᵀ)) X
    cb = torch.einsum("bctn,bcsn->bcts", cf, bf)          # (B,C,L,L)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", cb[..., None] * m, xf)

    # chunk-boundary states: s_c = sum_s (prod_{j=s+1..L} a_j) x_s ⊗ b_s
    w = torch.exp(cum[:, :, -1:, :] - cum)               # (B,C,L,H)
    chunk_state = torch.einsum("bcth,bcthp,bctn->bchpn", w, xf, bf)
    a_chunk = torch.exp(cum[:, :, -1, :])                # total chunk decay (B,C,H)

    h = torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_prevs = []                                          # state BEFORE each chunk
    for ci in range(nc):
        h_prevs.append(h)
        h = a_chunk[:, ci, :, None, None] * h + chunk_state[:, ci]

    # inter-chunk: y_inter[t] = (prod_{j<=t} a_j) * (c_t @ h_prev)
    y_inter = torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(cum), cf,
                           torch.stack(h_prevs, 1))

    y = (y_intra + y_inter).reshape(bsz, nc * L, nh, p)[:, :t]
    return y.to(x.dtype), h


__all__ = ["ssd_chunked", "ssd_scan", "ssd_decode_step"]
