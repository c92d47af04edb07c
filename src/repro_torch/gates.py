"""Scale-relative gates for comparing a tensor with its expected value (the
port's training gradients and losses, on the host and on the card).

Each gate works per tensor and relative to the expected tensor's own scale:

    rel = ||got - want||_2 / ||want||_2  <=  REL
    |got - want| <= A * rms(want) + R * |want|   elementwise

so a tensor whose values are all small is held to its own size, never to
an absolute term as large as a typical value. ``None`` skips a clause.

=================  =====  ====  =====  ==========================================
gate               REL    A     R      compares
=================  =====  ====  =====  ==========================================
host_f32           1e-5   1e-4  1e-5   plain versions / Function on the CPU vs
                                       the JAX reference's VJP, float32
host_bf16          1e-2   2e-2  2^-7   the same with bf16 inputs (f32 math
                                       inside, bf16 out)
model_f32          1e-4   1e-3  1e-4   a reduced model's loss and every grad leaf
                                       vs the JAX reference, float32
card_f32           1e-5   1e-4  1e-5   a kernel vs its plain version on the card
card_bf16          1e-2   2e-2  2^-7   the same, bf16
full_width_bf16    5e-2   —     —      full-width grads, kernels vs plain versions
full_width_f32     1e-4   —     —      the same with float32 params, where no
                                       bf16 rounding hides a fault
=================  =====  ====  =====  ==========================================

A logsumexp is compared in absolute terms, |got - want| <= 1e-5 max(1,
|want|), and must be exactly 0 on rows that see no key. A loss curve of the
kernels against the plain versions must agree within LOSS_REL of the loss
at every step (LOSS_REL_F32 with float32 params).
"""

from __future__ import annotations

import torch

GATES = {
    "host_f32": (1e-5, 1e-4, 1e-5),
    "host_bf16": (1e-2, 2e-2, 2.0 ** -7),
    "model_f32": (1e-4, 1e-3, 1e-4),
    "card_f32": (1e-5, 1e-4, 1e-5),
    "card_bf16": (1e-2, 2e-2, 2.0 ** -7),
    "full_width_bf16": (5e-2, None, None),
    "full_width_f32": (1e-4, None, None),
}
LSE_TOL = 1e-5
LOSS_REL = 5e-3
LOSS_REL_F32 = 1e-4


def measure(got: torch.Tensor, want: torch.Tensor, gate: str) -> dict:
    """``rel`` and ``worst`` (the largest |got - want| over its elementwise
    limit; <= 1 passes) of ``got`` against ``want`` under ``gate``, and
    ``ok``. Computed in float64 on ``want``'s device."""
    rel_max, a, r = GATES[gate]
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    g = got.detach().to(want.device, torch.float64)
    w = want.detach().to(torch.float64)
    err = g - w
    wn = w.norm().item()
    rel = err.norm().item() / wn if wn > 0 else (0.0 if err.norm().item() == 0 else
                                                 float("inf"))
    ok = bool(torch.isfinite(g).all()) and rel <= rel_max
    worst = 0.0
    if a is not None:
        limit = a * w.square().mean().sqrt() + r * w.abs()
        over = err.abs() / limit
        # 0 / 0 where want and its rms are 0: equal is within, unequal is not
        over = torch.where(err == 0, 0.0, over)
        worst = over.max().item() if over.numel() else 0.0
        ok = ok and worst <= 1.0
    return {"rel": rel, "worst": worst, "ok": ok}


def check(got: torch.Tensor, want: torch.Tensor, gate: str, name: str) -> dict:
    """:func:`measure`, raising AssertionError when the gate fails."""
    m = measure(got, want, gate)
    if not m["ok"]:
        raise AssertionError(f"{name}: gate {gate} {GATES[gate]} fails: rel "
                             f"{m['rel']:.3g}, worst elementwise {m['worst']:.3g} of "
                             f"its limit")
    return m


def check_lse(got: torch.Tensor, want: torch.Tensor, no_key: torch.Tensor,
              name: str) -> float:
    """lse within LSE_TOL max(1, |want|), exactly 0 on the ``no_key`` rows
    (a bool mask broadcastable to lse). Returns the largest error over its
    limit."""
    g = got.detach().to(want.device, torch.float64)
    w = want.detach().to(torch.float64)
    no_key = no_key.to(want.device).expand_as(w)
    if bool((g[no_key] != 0).any()):
        raise AssertionError(f"{name}: lse is not 0 on a row that sees no key")
    over = ((g - w).abs() / (LSE_TOL * w.abs().clamp_min(1.0))).max().item() \
        if w.numel() else 0.0
    if not over <= 1.0:
        raise AssertionError(f"{name}: lse off by {over:.3g} of {LSE_TOL} max(1, |lse|)")
    return over
