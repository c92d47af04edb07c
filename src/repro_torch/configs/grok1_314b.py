"""grok-1-314b [moe]: 8 experts, top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2
[hf:xai-org/grok-1; unverified]

The JAX package's configuration (``repro/configs/grok1_314b.py``): every
block's MLP is a capacity-bounded mixture of 8 SwiGLU experts
(``nn/moe.py``), capacity factor 1.25.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=1.25,
    rope_theta=1e4,
    source="hf:xai-org/grok-1; unverified",
)
