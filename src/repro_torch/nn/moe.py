"""Mixture-of-experts layer (grok, arctic) on the TSL moe primitives
(mirrors ``repro/nn/moe.py``).

Capacity-based dispatch (static shapes), the batched expert FFN, arctic's
optional dense residual branch, and the Switch-style load-balancing aux
term returned beside the output. The reference's sharding constraints pin
layouts on a mesh and are no-ops on one device, so they are left out.
"""

from __future__ import annotations

import torch

from .mlp import init_mlp, mlp_forward


def init_moe(cfg, make, lead=()):
    """The moe leaves (the reference's names: ``router``, ``w_gate``,
    ``w_up``, ``w_down`` and, for arctic, the ``dense`` residual MLP of width
    ``dense_residual_ff``), each with the ``lead`` (stacked layer) axes."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": make("dense", (*lead, d, e)),
        "w_gate": make("dense", (*lead, e, d, ff)),
        "w_up": make("dense", (*lead, e, d, ff)),
        "w_down": make("dense", (*lead, e, ff, d)),
    }
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(cfg.replace(d_ff=cfg.dense_residual_ff or d), make, lead)
    return p


def capacity_for(cfg, tokens: int) -> int:
    """Rows each expert takes in a step of ``tokens`` tokens: at least 8."""
    cap = int(tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, cap)


def moe_forward(tsl, p, x, cfg):
    """x (B, S, D) -> (y (B, S, D), aux 0-d float32).

    Every row of the step routes together, padding rows and idle slots
    included: a row past an expert's capacity is dropped (its expert
    output is zero), so a token's output depends on the rows routed before
    it."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    logits = tsl.matmul(x2, p["router"])
    weights, idx = tsl.topk_gating(logits, k=cfg.experts_per_token)
    cap = capacity_for(cfg, b * s)
    xe, info = tsl.moe_dispatch(x2, idx, weights, n_experts=cfg.n_experts, capacity=cap)
    ye = tsl.expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
    y = tsl.moe_combine(ye, info).reshape(b, s, d)

    # Switch-style load-balance aux: E * sum_e f_e * p_e
    gates = torch.softmax(logits.float(), dim=-1)
    importance = gates.mean(dim=0)
    load = (idx[:, 0, None] == torch.arange(cfg.n_experts, device=x.device)).float().mean(0)
    aux = cfg.n_experts * torch.sum(importance * load)

    if cfg.moe_dense_residual:
        y = y + mlp_forward(tsl, p["dense"], x, cfg).reshape(b, s, d)
    return y, aux
