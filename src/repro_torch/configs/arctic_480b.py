"""arctic-480b [moe]: 128 experts top-2 + dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]

The JAX package's configuration (``repro/configs/arctic_480b.py``):
Arctic's dense-MoE hybrid, a dense SwiGLU MLP of width
``dense_residual_ff`` running in parallel (residual) with the 128-expert
MoE FFN.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    dense_residual_ff=7168,
    capacity_factor=1.25,
    rope_theta=1e4,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
