"""internvl2-2b [vlm]: InternViT frontend (STUB) + InternLM2-1.8B backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]

The JAX package's configuration (``repro/configs/internvl2_2b.py``): the
modality frontend is a stub, so a request brings precomputed patch
embeddings (``vision_prefix`` rows of width d_model) that the backbone
projects (``vision_proj``) and reads ahead of its first prompt token.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    vision_prefix=256,            # one ViT tile of patch embeddings
    rope_theta=1e6,
    source="arXiv:2404.16821; hf",
)
