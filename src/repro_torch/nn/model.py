"""Model facade (mirrors ``repro/nn/model.py``) for every family of the
reference: the ``lm`` backbone's dense, ``moe`` (grok, arctic) and ``vlm``
(internvl2) families, the rwkv (``ssm``) family, the zamba (``hybrid``)
family and the whisper (``audio``) family.

``build_model(cfg, device=...)`` returns a :class:`Model` (dense, moe, vlm), a
:class:`RwkvModel`, a :class:`ZambaModel` or an :class:`EncDecModel` bound
to the generated library for its device (``h100``
kernels on the card, ``torch_cpu`` plain versions on the host; ``target=``
overrides), with one surface:

    init(seed) -> params                 (seeded torch.Generator on the device)
    forward_logits(params, batch) -> logits (B,S,V)
        (vlm: ``batch["vision_embeds"]`` (B, vision_prefix, D), when given,
         goes ahead of the tokens: S + vision_prefix rows of logits)
    loss(params, batch, *, remat=True) -> (scalar, {"ce", "aux"})
        (mean next-token cross-entropy of ``batch["labels"]`` plus 0.01·aux,
         aux 0 for the dense family; differentiable: a train step makes the
         params leaves that require grad, serving keeps inference mode)
    prefill(params, batch, max_len) -> (last_logits (B,V), state)
        (audio: ``batch["audio_embeds"]`` (B, enc_len, D) too; vlm:
         ``batch["vision_embeds"]``, the cache then filled to prefix + S)
    prefill_chunk(params, state, tokens, pos, n_real=None[, embeds=None])
        -> (logits (B,C,V), state)
        (continuation prefill of one chunk at cache fill ``pos``, an int or
         a (B,) device tensor; ``n_real`` (int or device tensor) counts the
         chunk's real rows, the rest trailing padding. The lm backbone's
         and the audio family ignore it: their padding rows need no masking
         (nn/attention.py; moe padding rows are routed like real ones, as
         in the reference). rwkv and zamba skip their recurrent updates
         exactly; rwkv ignores ``pos``. ``embeds``, the audio and vlm
         families' only, rides the FIRST chunk, as the reference's does:
         audio, the request's (B, enc_len, D) frames (the encoder runs
         there and seeds the cross K/V); vlm, its (B, vision_prefix, D)
         patch embeddings, whose projected rows go ahead of the chunk's
         (logits (B, prefix + C, V)). The reference's ``kv_len`` has no
         counterpart)
    decode_step(params, state, tokens_t, pos) -> (logits (B,V), state)
        (pos: int, or a (B,) tensor of per-slot positions)
    verify_step(params, state, tokens, pos) -> (logits (B,SV,V), state)
        (speculative decoding: score a span of SV = k+1 tokens per slot — the
         pending token and k drafts — in one ragged batched step at the (B,)
         per-slot base rows ``pos``; logits row j validates draft j+1 and is
         independent of rows > j. Dense: the span's cache rows are written
         in place, and rollback is free, the accepted fill stops short of
         rejected rows; rwkv: nothing is written; zamba: the tails are not
         written, the shared block's span rows are; see verify_commit)
    init_decode_state(batch, max_len) -> zeroed state dict
        (audio: ``enc_len=`` sizes the cross K/V, default max_len)
    state_batch_axes(state) -> {leaf: slot axis}
    state_page_axes(state) -> {leaf: token axis | None}  (paged serving)
    decode_step_paged(params, state, pools, tables, tokens_t, pos)
        -> (logits (B,V), state, pools)
        (fused paged decode straight off the block-table page pools; ``state``
         is the tail-only dict, empty for the dense family)
    verify_step_paged(params, state, pools, tables, tokens, pos)
        -> (logits (B,SV,V), state, pools)
        (the verify span straight off the pools, through
         ``attention_verify_paged``)
    verify_commit(params, state, tokens, pos, n_commit) -> state | None
        (None for the dense family, whose verify step already committed the
         span's rows; rwkv's and zamba's commit replays the accepted prefix
         of the span through prefill_chunk at the (B,) base rows ``pos``
         with the (B,) per-slot ``n_commit`` real rows: 0 leaves a slot's
         recurrent state exactly as it was)
    verify_commit_paged(params, state, pools, tables, tokens, pos, n_commit)
        -> (state, pools) | None
        (zamba's commit on the pools, the first family that has one; None
         for the dense family and rwkv, which has no paged leaf: its
         ``decode_step_paged`` / ``verify_step_paged`` are None too, and the
         engine serves it from lanes in paged mode)
    insert_slot(state, donor, slot) / reset_slot(state, slot)

Unlike the reference, state is updated IN PLACE by prefill_chunk,
decode_step, the dense verify_step, the recurrent families' verify_commit,
insert_slot and reset_slot (each still returns it), and the page pools by
decode_step_paged, verify_step_paged and zamba's verify_commit_paged. rwkv
zamba, whisper, vlm and moe are served, not trained: their ``loss`` raises.

``load_jax_params(np_tree, cfg, device)`` turns the reference's params
(``build_model(cfg).init(PRNGKey(s))``, ``np.asarray`` per leaf) into this
model's params, 1:1 with no transposes, each leaf in its own dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import numpy as np
import torch

from repro_torch import tsl_api
from repro_torch.configs.arch import ArchConfig
from repro_torch.device import resolve_device

from . import encdec, lm, rwkv_lm, zamba
from .common import init_leaf

# where rwkv's, zamba's, whisper's, internvl2's and the moe family's
# training stand
RWKV_TRAIN_TODO = "training the ssm (rwkv) family is not ported yet " \
                  "(ROADMAP.md, queue 1, item 11)"
HYBRID_TRAIN_TODO = "training the hybrid (zamba) family is not ported yet " \
                    "(ROADMAP.md, queue 1, item 12)"
AUDIO_TRAIN_TODO = "training the audio (whisper) family is not ported yet " \
                   "(ROADMAP.md, queue 1, item 13)"
VLM_TRAIN_TODO = "training the vlm (internvl2) family is not ported yet " \
                 "(ROADMAP.md, queue 1, item 14)"
MOE_TRAIN_TODO = "training the moe (grok, arctic) family is not ported yet " \
                 "(ROADMAP.md, queue 1, item 15)"
TRAIN_TODO = {"ssm": RWKV_TRAIN_TODO, "hybrid": HYBRID_TRAIN_TODO,
              "audio": AUDIO_TRAIN_TODO, "vlm": VLM_TRAIN_TODO, "moe": MOE_TRAIN_TODO}


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _init_make(model: "Model", seed: int):
    g = torch.Generator(device=model.device).manual_seed(seed)
    return lambda kind, shape, **kw: init_leaf(kind, shape, dtype=model.dtype,
                                               device=model.device, generator=g, **kw)


@dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    lib: ModuleType              # the generated TSL library the model runs on

    @property
    def tsl(self):
        return self.lib.ops

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    def init(self, seed: int = 0) -> dict:
        return lm.lm_params(self.cfg, _init_make(self, seed))

    def forward_logits(self, params, batch):
        logits, _ = lm.lm_forward(self.tsl, params, batch["tokens"], self.cfg,
                                  vision_embeds=batch.get("vision_embeds"))
        return logits

    def loss(self, params, batch, *, remat: bool = True):
        if self.cfg.family in TRAIN_TODO:
            raise NotImplementedError(TRAIN_TODO[self.cfg.family])
        logits, _ = lm.lm_forward(self.tsl, params, batch["tokens"], self.cfg,
                                  remat=remat)
        ce = self.tsl.cross_entropy(logits, batch["labels"]).mean()
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, max_len: int):
        return lm.lm_prefill(self.tsl, params, batch["tokens"], self.cfg,
                             max_len=max_len, vision_embeds=batch.get("vision_embeds"))

    def prefill_chunk(self, params, state, tokens, pos, n_real=None, embeds=None):
        return lm.lm_prefill_chunk(self.tsl, params, state, tokens, pos, self.cfg,
                                   vision_embeds=embeds)

    def decode_step(self, params, state, tokens_t, pos):
        return lm.lm_decode_step(self.tsl, params, state, tokens_t, pos, self.cfg)

    def init_decode_state(self, batch: int, max_len: int):
        return lm.init_decode_state(self.cfg, batch, max_len, self.dtype, self.device)

    def state_batch_axes(self, state):
        return lm.state_batch_axes(state)

    def state_page_axes(self, state):
        return lm.state_page_axes(state)

    def decode_step_paged(self, params, state, pools, tables, tokens_t, pos):
        return lm.lm_decode_step_paged(self.tsl, params, state, pools, tables, tokens_t,
                                       pos, self.cfg)

    def verify_step(self, params, state, tokens, pos):
        return lm.lm_verify_step(self.tsl, params, state, tokens, pos, self.cfg)

    def verify_step_paged(self, params, state, pools, tables, tokens, pos):
        return lm.lm_verify_step_paged(self.tsl, params, state, pools, tables, tokens,
                                       pos, self.cfg)

    # the verify steps commit the span's rows themselves (KV family)
    verify_commit = None
    verify_commit_paged = None

    # -- state surgery (continuous batching: serve/ builds on these) ---------

    def insert_slot(self, state, donor, slot: int):
        """Graft a single-request decode state (slot axis of size 1, e.g.
        straight from ``prefill`` with batch 1) into slot ``slot`` of a live
        batched state, in place."""
        for name, ax in self.state_batch_axes(state).items():
            state[name].narrow(ax, int(slot), 1).copy_(donor[name])
        return state

    def reset_slot(self, state, slot: int):
        """Zero slot ``slot`` (request finished / evicted), in place."""
        for name, ax in self.state_batch_axes(state).items():
            state[name].narrow(ax, int(slot), 1).zero_()
        return state


class RwkvModel(Model):
    """The rwkv (``ssm``) family: RWKV6 blocks over a fixed-size recurrent
    state (``nn/rwkv_lm.py``). Served in lane mode (paged mode falls back to
    lanes: nothing pages), with speculation through a verify step that
    writes nothing and a commit that replays the accepted prefix."""

    def init(self, seed: int = 0) -> dict:
        return rwkv_lm.rwkv_params(self.cfg, _init_make(self, seed))

    def forward_logits(self, params, batch):
        return rwkv_lm.rwkv_forward(self.tsl, params, batch["tokens"], self.cfg)

    def loss(self, params, batch, *, remat: bool = True):
        raise NotImplementedError(RWKV_TRAIN_TODO)

    def prefill(self, params, batch, max_len: int):
        return rwkv_lm.rwkv_prefill(self.tsl, params, batch["tokens"], self.cfg)

    def prefill_chunk(self, params, state, tokens, pos, n_real=None):
        return rwkv_lm.rwkv_prefill_chunk(self.tsl, params, state, tokens, self.cfg,
                                          n_real=n_real)

    def decode_step(self, params, state, tokens_t, pos):
        return rwkv_lm.rwkv_decode_step(self.tsl, params, state, tokens_t, self.cfg)

    def init_decode_state(self, batch: int, max_len: int):
        return rwkv_lm.init_rwkv_state(self.cfg, batch, self.dtype, self.device)

    def state_batch_axes(self, state):
        return rwkv_lm.state_batch_axes(state)

    def state_page_axes(self, state):
        return rwkv_lm.state_page_axes(state)

    def verify_step(self, params, state, tokens, pos):
        return rwkv_lm.rwkv_verify_step(self.tsl, params, state, tokens, self.cfg)

    def verify_commit(self, params, state, tokens, pos, n_commit):
        """Replay the accepted prefix of the span: ``n_commit`` (B,) real rows
        per slot, in place (0: the slot is left exactly as it was)."""
        return rwkv_lm.rwkv_prefill_chunk(self.tsl, params, state, tokens, self.cfg,
                                          n_real=n_commit)[1]

    # no paged leaf: no fused paged contract
    decode_step_paged = None
    verify_step_paged = None
    verify_commit_paged = None


class ZambaModel(Model):
    """The zamba (``hybrid``) family: Mamba2 blocks with one shared
    attention block after every ``attn_every`` of them (``nn/zamba.py``).
    Its state has both kinds: the Mamba2 tails (fixed size per request) and
    the shared block's KV caches, which page. Served in lane mode and fused
    paged mode (the KV caches in the pools, the tails in the slot table),
    with speculation through a verify step that leaves the tails as they
    were and a commit that replays the accepted prefix, in lanes or on the
    pools."""

    def init(self, seed: int = 0) -> dict:
        return zamba.zamba_params(self.cfg, _init_make(self, seed))

    def forward_logits(self, params, batch):
        return zamba.zamba_forward(self.tsl, params, batch["tokens"], self.cfg)

    def loss(self, params, batch, *, remat: bool = True):
        raise NotImplementedError(HYBRID_TRAIN_TODO)

    def prefill(self, params, batch, max_len: int):
        return zamba.zamba_prefill(self.tsl, params, batch["tokens"], self.cfg,
                                   max_len=max_len)

    def prefill_chunk(self, params, state, tokens, pos, n_real=None):
        return zamba.zamba_prefill_chunk(self.tsl, params, state, tokens, pos, self.cfg,
                                         n_real=n_real)

    def decode_step(self, params, state, tokens_t, pos):
        return zamba.zamba_decode_step(self.tsl, params, state, tokens_t, pos, self.cfg)

    def init_decode_state(self, batch: int, max_len: int):
        return zamba.init_zamba_state(self.cfg, batch, max_len, self.dtype, self.device)

    def state_batch_axes(self, state):
        return zamba.state_batch_axes(state)

    def state_page_axes(self, state):
        return zamba.state_page_axes(state)

    def verify_step(self, params, state, tokens, pos):
        return zamba.zamba_verify_step(self.tsl, params, state, tokens, pos, self.cfg)

    def verify_commit(self, params, state, tokens, pos, n_commit):
        """Replay the accepted prefix of the span at the (B,) base rows
        ``pos``: ``n_commit`` (B,) real rows per slot, in place (0: the
        slot's tails are left exactly as they were)."""
        return zamba.zamba_prefill_chunk(self.tsl, params, state, tokens, pos, self.cfg,
                                         n_real=n_commit)[1]

    def decode_step_paged(self, params, state, pools, tables, tokens_t, pos):
        return zamba.zamba_decode_step_paged(self.tsl, params, state, pools, tables,
                                             tokens_t, pos, self.cfg)

    def verify_step_paged(self, params, state, pools, tables, tokens, pos):
        return zamba.zamba_verify_step_paged(self.tsl, params, state, pools, tables, tokens,
                                             pos, self.cfg)

    def verify_commit_paged(self, params, state, pools, tables, tokens, pos, n_commit):
        return zamba.zamba_verify_commit_paged(self.tsl, params, state, pools, tables,
                                               tokens, pos, self.cfg, n_commit)


class EncDecModel(Model):
    """The whisper (``audio``) family: an encoder over precomputed frame
    embeddings and a decoder with causal self-attention and cross-attention
    to the encoder's K/V (``nn/encdec.py``). Its state has both kinds: the
    self-attention caches, which page, and the per-request cross K/V, fixed
    at ``enc_len`` rows (tails). Served in lane and fused paged mode, with
    speculation (a KV family: the verify steps commit their own rows)."""

    def init(self, seed: int = 0) -> dict:
        return encdec.encdec_params(self.cfg, _init_make(self, seed))

    def forward_logits(self, params, batch):
        return encdec.encdec_forward(self.tsl, params, batch["tokens"], self.cfg,
                                     audio_embeds=batch["audio_embeds"])

    def loss(self, params, batch, *, remat: bool = True):
        raise NotImplementedError(AUDIO_TRAIN_TODO)

    def prefill(self, params, batch, max_len: int):
        return encdec.encdec_prefill(self.tsl, params, batch["tokens"], self.cfg,
                                     audio_embeds=batch["audio_embeds"], max_len=max_len)

    def prefill_chunk(self, params, state, tokens, pos, n_real=None, embeds=None):
        return encdec.encdec_prefill_chunk(self.tsl, params, state, tokens, pos, self.cfg,
                                           audio_embeds=embeds)

    def decode_step(self, params, state, tokens_t, pos):
        return encdec.encdec_decode_step(self.tsl, params, state, tokens_t, pos, self.cfg)

    def init_decode_state(self, batch: int, max_len: int, enc_len: int | None = None):
        return encdec.init_encdec_state(self.cfg, batch, max_len,
                                        max_len if enc_len is None else enc_len,
                                        self.dtype, self.device)

    def state_batch_axes(self, state):
        return encdec.state_batch_axes(state)

    def state_page_axes(self, state):
        return encdec.state_page_axes(state)

    def verify_step(self, params, state, tokens, pos):
        return encdec.encdec_verify_step(self.tsl, params, state, tokens, pos, self.cfg)

    def decode_step_paged(self, params, state, pools, tables, tokens_t, pos):
        return encdec.encdec_decode_step_paged(self.tsl, params, state, pools, tables,
                                               tokens_t, pos, self.cfg)

    def verify_step_paged(self, params, state, pools, tables, tokens, pos):
        return encdec.encdec_verify_step_paged(self.tsl, params, state, pools, tables,
                                               tokens, pos, self.cfg)


_FAMILIES = {"dense": (Model, lm.lm_params), "moe": (Model, lm.lm_params),
             "vlm": (Model, lm.lm_params), "ssm": (RwkvModel, rwkv_lm.rwkv_params),
             "hybrid": (ZambaModel, zamba.zamba_params),
             "audio": (EncDecModel, encdec.encdec_params)}


def _family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported "
                                  f"(the families are {sorted(_FAMILIES)})")
    if cfg.family in ("dense", "moe", "vlm") and (cfg.act, cfg.norm) != ("swiglu",
                                                                         "rmsnorm"):
        # the lm backbone's configs are all swiglu / rmsnorm, as are the
        # reference's: another pair is a config no family here describes
        raise NotImplementedError(
            f"{cfg.name}: an lm-backbone config with ({cfg.act}, {cfg.norm}) is not "
            f"ported: the dense, moe and vlm families are swiglu / rmsnorm")
    if cfg.family == "moe" and not (0 < cfg.experts_per_token <= cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: a moe config with n_experts={cfg.n_experts} and "
            f"experts_per_token={cfg.experts_per_token} is not ported: the moe family "
            f"routes each token to 0 < experts_per_token <= n_experts experts")
    if cfg.family == "vlm" and cfg.vision_prefix <= 0:
        raise NotImplementedError(
            f"{cfg.name}: a vlm config with vision_prefix={cfg.vision_prefix} is not "
            f"ported: the vlm family reads vision_prefix > 0 patch rows")
    if cfg.family == "hybrid" and (cfg.attn_every <= 0 or cfg.ssm_state <= 0):
        # zamba's layout divides the layers by attn_every, and its SSD has
        # ssm_state channels: a config without either is no zamba
        raise NotImplementedError(
            f"{cfg.name}: a hybrid config with attn_every={cfg.attn_every} and "
            f"ssm_state={cfg.ssm_state} is not ported: the hybrid family is zamba2's "
            f"layout, a shared attention block after every attn_every > 0 Mamba2 "
            f"layers of ssm_state > 0 channels")
    if cfg.family == "audio" and (not cfg.enc_dec or cfg.n_enc_layers <= 0):
        raise NotImplementedError(
            f"{cfg.name}: an audio config with enc_dec={cfg.enc_dec} and "
            f"n_enc_layers={cfg.n_enc_layers} is not ported: the audio family is "
            f"whisper's encoder-decoder, n_enc_layers > 0 encoder layers")
    return _FAMILIES[cfg.family]


def build_model(cfg: ArchConfig, *, device: torch.device | str = "cuda",
                target: str | None = None) -> Model:
    cls, _ = _family(cfg)
    dev = resolve_device(device)
    return cls(cfg=cfg, device=dev, lib=tsl_api.lib(dev, target=target))


def load_jax_params(np_tree: dict, cfg: ArchConfig,
                    device: torch.device | str = "cuda") -> dict:
    """The reference's params as this port's params: the same nested dict
    and the same stacked (L, ...) leaves (zamba's grouped (G, k, ...) and
    remainder (rem, ...) ones; whisper's ``enc_blocks`` and ``dec_blocks``,
    its layernorms' ``b`` leaves among them; the moe blocks' ``moe`` subtree
    with its (L, E, ...) experts and arctic's ``dense``; internvl2's
    ``vision_proj``), copied 1:1 (no transposes), each in its own
    dtype (rwkv's ``w_base``, zamba's ``A_log``, ``dt_bias`` and ``D_skip``
    are float32 in a bf16 model). Raises on a missing, extra or misshaped
    leaf."""
    dev = resolve_device(device)
    want = _family(cfg)[1](cfg, lambda kind, shape, **kw: tuple(shape))

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"params{path}: keys {got} != {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}[{k!r}]") for k in spec}
        arr = np.asarray(node)
        if tuple(arr.shape) != spec:
            raise ValueError(f"params{path}: shape {arr.shape} != {spec}")
        # bf16 arrives as an ml_dtypes array, which torch cannot wrap: go via f32
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=torch_dtype(arr.dtype.name))

    return convert(np_tree, want, "")
