"""Plain torch mixture-of-experts primitives: the ``torch_cpu`` definitions
of ``topk_gating``, ``moe_dispatch``, ``moe_combine`` and ``expert_ffn``
(``repro/tsl_data/primitives/moe.yaml``, arithmetic kept step for step).

* ``topk_gating`` breaks ties by the LOWER expert index, as
  ``jax.lax.top_k`` does (``torch.topk`` promises no order among equal
  values on the card): a stable descending sort.
* ``moe_dispatch``'s slot of a (token, choice) row is its rank among the rows
  routed to its expert, in row order (a one-hot cumsum); rows at or past
  ``capacity`` are dropped: zeroed and added into the clipped last slot, so
  they leave it as it was. A kept row's output thus depends on every row
  routed before it in the step, padding rows included.
* ``expert_ffn`` upcasts the weights to float32 as the reference does, but a
  block of experts at a time (``block_bytes`` of float32 copies at most, one
  expert when one alone is larger), so the float32 transient stays a few GB
  at full width instead of three (E, D, F) float32 copies.
"""

from __future__ import annotations

import torch

# float32 weight copies expert_ffn makes at once, at most (one expert's three
# weights when they alone are larger: 2.4 GB for grok-1-314b)
BLOCK_BYTES = 2 << 30


def topk_gating(logits: torch.Tensor, k: int = 2):
    """(T, E) router logits -> (weights (T, k) in logits' dtype, the softmax of
    the k largest float32 logits; idx (T, k) int64, largest first, the lower
    index first among equal logits)."""
    lf = logits.float()
    vals, idx = torch.sort(lf, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return torch.softmax(vals, dim=-1).to(logits.dtype), idx


def moe_dispatch(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor, *,
                 n_experts: int, capacity: int):
    """x (T, D), idx / weights (T, k) -> (xe (E, capacity, D), info).

    info = (flat_e, slot_c, keep, w, t): per (token, choice) row in row
    order its expert, its clipped slot, whether it was kept, its weight, and
    the token count — what :func:`moe_combine` inverts."""
    t, d = x.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1).long()
    onehot = (flat_e[:, None] == torch.arange(n_experts, device=x.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1
    slot = torch.sum(pos * onehot, dim=1)
    keep = slot < capacity
    slot_c = slot.clamp(0, capacity - 1)
    src = torch.repeat_interleave(x, k, dim=0)
    src = torch.where(keep[:, None], src, torch.zeros((), dtype=x.dtype, device=x.device))
    xe = torch.zeros((n_experts, capacity, d), dtype=x.dtype, device=x.device)
    xe.index_put_((flat_e, slot_c), src, accumulate=True)
    return xe, (flat_e, slot_c, keep, weights.reshape(-1), t)


def moe_combine(xe: torch.Tensor, info) -> torch.Tensor:
    """Gather each kept row's expert output, weight it in float32 and sum a
    token's k rows: (T, D) in xe's dtype."""
    flat_e, slot, keep, w, t = info
    gathered = xe[flat_e, slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=xe.dtype, device=xe.device))
    y = gathered.float() * w.float()[:, None]
    return y.reshape(t, -1, xe.shape[-1]).sum(dim=1).to(xe.dtype)


def expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """Per-expert SwiGLU over the dispatched (E, C, D) block, in float32 (the
    weights upcast ``block_bytes`` at a time); the result in xe's dtype."""
    e, c, d = xe.shape
    f = w_gate.shape[-1]
    xf = xe.float()
    out = torch.empty((e, c, d), dtype=torch.float32, device=xe.device)
    per_expert = 3 * d * f * 4
    blk = max(1, block_bytes // per_expert)
    for e0 in range(0, e, blk):
        sl = slice(e0, min(e0 + blk, e))
        g = torch.bmm(xf[sl], w_gate[sl].float())
        u = torch.bmm(xf[sl], w_up[sl].float())
        h = g * torch.sigmoid(g) * u
        out[sl] = torch.bmm(h, w_down[sl].float())
    return out.to(xe.dtype)
