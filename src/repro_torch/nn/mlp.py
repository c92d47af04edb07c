"""Dense MLP blocks on TSL primitives: SwiGLU (the dense, zamba and rwkv
configs) or GELU (whisper's ``act="gelu"``), mirroring ``repro/nn/mlp.py``."""

from __future__ import annotations


def init_mlp(cfg, make, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": make("dense", (*lead, d, ff)),
            "w_up": make("dense", (*lead, d, ff)),
            "w_down": make("dense", (*lead, ff, d)),
        }
    return {
        "w_in": make("dense", (*lead, d, ff)),
        "w_out": make("dense", (*lead, ff, d)),
    }


def mlp_forward(tsl, p, x, cfg):
    if "w_gate" in p:
        g = tsl.matmul(x, p["w_gate"])
        u = tsl.matmul(x, p["w_up"])
        return tsl.matmul(tsl.swiglu(g, u), p["w_down"])
    return tsl.matmul(tsl.gelu(tsl.matmul(x, p["w_in"])), p["w_out"])
