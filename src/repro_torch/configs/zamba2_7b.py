"""zamba2-7b [hybrid]: 81L Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified]

Layout (the JAX package's, ``repro/configs/zamba2_7b.py``): the published
model interleaves two shared attention blocks; this models ONE shared
attention block applied after every 6th Mamba2 layer (13 applications over
81 layers, then a remainder stack of 3) — the same parameter sharing, the
same asymptotics. d_inner = 2·d_model = 7168, P=64 ⇒ 112 SSD heads; the
shared block's heads are 32 of 112.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    d_inner_mult=2,
    attn_every=6,
    conv_width=4,
    rope_theta=1e4,
    source="arXiv:2411.15242; unverified",
)
