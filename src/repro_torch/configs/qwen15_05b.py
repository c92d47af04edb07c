"""qwen1.5-0.5b [dense]: QKV bias, kv=16 (full MHA).

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf]
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e4,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
