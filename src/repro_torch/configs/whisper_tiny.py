"""whisper-tiny [audio]: encoder-decoder, conv frontend STUB.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356; unverified]

The JAX package's configuration (``repro/configs/whisper_tiny.py``): the
conv frontend is a stub, so the encoder takes precomputed frame embeddings
(B, enc_len, d_model) — 1500 frames for Whisper's 30-second window. The
decoder is causal with cross-attention to the encoder's K/V. LayerNorm and
GELU (tanh form); RoPE in both self-attentions stands in for Whisper's
learned positions, as in the reference.
"""

from .arch import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    n_enc_layers=4,             # encoder layers
    enc_dec=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    source="arXiv:2212.04356; unverified",
)
