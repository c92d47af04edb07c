"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
[arXiv:2404.05892; hf]

64 WKV heads of size 64 (d_model/64). flash_attention is inapplicable to this
arch — sequence mixing is the wkv6_scan TSL primitive.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    norm_eps=1e-5,
    source="arXiv:2404.05892; hf",
)
