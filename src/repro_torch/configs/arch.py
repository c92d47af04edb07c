"""Architecture configuration dataclass + shape-cell definitions.

One ``configs/<id>.py`` per assigned architecture instantiates ArchConfig with
the exact published numbers; ``reduced()`` derives the CPU smoke-test variant
(same family, tiny widths).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention details
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen1.5
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic
    dense_residual_ff: int = 0        # arctic's parallel dense MLP width
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0                # mamba2 N
    ssm_head_dim: int = 64            # mamba2 P
    d_inner_mult: int = 2             # mamba2 d_inner = mult * d_model
    attn_every: int = 0               # zamba2: shared attn block every k layers
    conv_width: int = 4
    rwkv_head_dim: int = 64           # rwkv6 K=V
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # VLM stub
    vision_prefix: int = 0            # patch-embedding stub tokens prepended
    # misc
    act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                  # provenance tag from the assignment table

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head table size: vocab padded to a multiple of 256 so
        the vocab dim shards on any mesh axis (standard production practice;
        whisper's 51865 and internvl2's 92553 are otherwise unshardable and
        waste model-axis FLOPs on the head matmul)."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def decode_prefix(self) -> int:
        """Cache rows the prefill prepends BEFORE the prompt (vlm vision
        embeddings): they consume decode slot-table budget exactly like
        prompt tokens, so every serving-side length calculation must add
        this. Single source of truth for engine/admission/CLI."""
        return self.vision_prefix if self.family == "vlm" else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell? (SSM / hybrid decode paths)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests (one fwd/train step)."""
        return self.replace(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            dense_residual_ff=64 if self.moe_dense_residual else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=8,
            rwkv_head_dim=16,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            vision_prefix=min(self.vision_prefix, 8),
            dtype="float32",
        )

    # -- analytic parameter count (roofline MODEL_FLOPS = 6·N·D) -------------

    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        h, kh = self.n_heads, self.n_kv_heads
        n = 0
        n += self.vocab * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab                   # lm head
        def attn_params() -> int:
            p = d * (h * hd) + 2 * d * (kh * hd) + (h * hd) * d
            if self.qkv_bias:
                p += h * hd + 2 * kh * hd
            if self.qk_norm:
                p += 2 * hd
            return p
        def mlp_params(ff: int) -> int:
            if self.act == "swiglu":
                return 3 * d * ff
            return 2 * d * ff
        if self.family in ("dense", "vlm"):
            per = attn_params() + mlp_params(self.d_ff) + 2 * d
            n += self.n_layers * per
        elif self.family == "moe":
            per = attn_params() + 2 * d
            per += self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.moe_dense_residual:
                per += mlp_params(self.dense_residual_ff or d)
            n += self.n_layers * per
            if active_only:
                n = self.vocab * d * (1 if self.tie_embeddings else 2)
                per = attn_params() + 2 * d + d * self.n_experts
                per += self.experts_per_token * 3 * d * self.d_ff
                if self.moe_dense_residual:
                    per += mlp_params(self.dense_residual_ff or d)
                n += self.n_layers * per
        elif self.family == "hybrid":
            d_in = self.d_inner_mult * d
            nh_ssm = d_in // self.ssm_head_dim
            per = 2 * d                            # norms
            per += d * (2 * d_in + 2 * self.ssm_state + nh_ssm)   # in_proj
            per += self.conv_width * d_in          # conv
            per += d_in * d                        # out_proj
            per += 2 * nh_ssm + d_in               # A_log, dt_bias, D skip + gate norm
            n += self.n_layers * per
            n += attn_params() + 2 * d             # ONE shared attention block
        elif self.family == "ssm":                 # rwkv6
            k = self.rwkv_head_dim
            nh_r = d // k
            per = 2 * d
            per += 5 * d + 4 * d * d + nh_r * k    # time-mix: mus, r/k/v/g proj, u
            per += d * 64 + 64 * d                 # w lora
            per += d * d                           # output proj
            per += 2 * d + d * self.d_ff + self.d_ff * d   # channel mix
            n += self.n_layers * per
        elif self.family == "audio":
            per = attn_params() + mlp_params(self.d_ff) + 2 * d
            n += self.n_enc_layers * per                       # encoder
            dec_per = attn_params() * 2 + mlp_params(self.d_ff) + 3 * d
            n += self.n_layers * dec_per                       # decoder (self+cross)
        return n
