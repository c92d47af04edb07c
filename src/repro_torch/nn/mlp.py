"""The dense SwiGLU MLP block on TSL primitives (every dense config is SwiGLU)."""

from __future__ import annotations


def init_mlp(cfg, make, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": make("dense", (*lead, d, ff)),
        "w_up": make("dense", (*lead, d, ff)),
        "w_down": make("dense", (*lead, ff, d)),
    }


def mlp_forward(tsl, p, x, cfg):
    g = tsl.matmul(x, p["w_gate"])
    u = tsl.matmul(x, p["w_up"])
    return tsl.matmul(tsl.swiglu(g, u), p["w_down"])
