"""Model facade (mirrors ``repro/nn/model.py``) for the dense family.

``build_model(cfg, device=...)`` returns a :class:`Model` bound to the
generated library for its device (``h100`` kernels on the card,
``torch_cpu`` plain versions on the host; ``target=`` overrides):

    init(seed) -> params                 (seeded torch.Generator on the device)
    forward_logits(params, batch) -> logits (B,S,V)
    loss(params, batch, *, remat=True) -> (scalar, {"ce", "aux"})
        (mean next-token cross-entropy of ``batch["labels"]`` plus 0.01·aux,
         aux 0 for the dense family; differentiable: a train step makes the
         params leaves that require grad, serving keeps inference mode)
    prefill(params, batch, max_len) -> (last_logits (B,V), state)
    prefill_chunk(params, state, tokens, pos) -> (logits (B,C,V), state)
        (continuation prefill of one chunk at cache fill ``pos``; trailing
         padding rows need no masking in the dense family — see
         nn/attention.py — so the reference's ``kv_len``/``n_real``/``embeds``
         arguments have no counterpart here)
    decode_step(params, state, tokens_t, pos) -> (logits (B,V), state)
        (pos: int, or a (B,) tensor of per-slot positions)
    init_decode_state(batch, max_len) -> zeroed state dict
    state_batch_axes(state) -> {leaf: slot axis}
    state_page_axes(state) -> {leaf: token axis | None}  (paged serving)
    decode_step_paged(params, state, pools, tables, tokens_t, pos)
        -> (logits (B,V), state, pools)
        (fused paged decode straight off the block-table page pools; ``state``
         is the tail-only dict, empty for this family; ``verify_step_paged`` /
         ``verify_commit_paged`` stay None until speculative decoding is
         ported)
    insert_slot(state, donor, slot) / reset_slot(state, slot)

Unlike the reference, state is updated IN PLACE by prefill_chunk,
decode_step, insert_slot and reset_slot (each still returns it), and the
page pools by decode_step_paged.

``load_jax_params(np_tree, cfg, device)`` turns the reference's params
(``build_model(cfg).init(PRNGKey(s))``, ``np.asarray`` per leaf) into this
model's params, 1:1 with no transposes.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import numpy as np
import torch

from repro_torch import tsl_api
from repro_torch.configs.arch import ArchConfig
from repro_torch.device import resolve_device

from . import lm
from .common import init_leaf


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


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
        g = torch.Generator(device=self.device).manual_seed(seed)
        return lm.lm_params(self.cfg, lambda kind, shape: init_leaf(
            kind, shape, dtype=self.dtype, device=self.device, generator=g))

    def forward_logits(self, params, batch):
        logits, _ = lm.lm_forward(self.tsl, params, batch["tokens"], self.cfg)
        return logits

    def loss(self, params, batch, *, remat: bool = True):
        logits, _ = lm.lm_forward(self.tsl, params, batch["tokens"], self.cfg,
                                  remat=remat)
        ce = self.tsl.cross_entropy(logits, batch["labels"]).mean()
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, max_len: int):
        return lm.lm_prefill(self.tsl, params, batch["tokens"], self.cfg,
                             max_len=max_len)

    def prefill_chunk(self, params, state, tokens, pos: int):
        return lm.lm_prefill_chunk(self.tsl, params, state, tokens, pos, self.cfg)

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

    # speculative decoding over the pools: not ported yet
    verify_step_paged = None
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


def build_model(cfg: ArchConfig, *, device: torch.device | str = "cuda",
                target: str | None = None) -> Model:
    if (cfg.family, cfg.act, cfg.norm) != ("dense", "swiglu", "rmsnorm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} ({cfg.act}, {cfg.norm}) is not "
            f"ported yet (this port has the dense swiglu/rmsnorm lm family only)")
    dev = resolve_device(device)
    return Model(cfg=cfg, device=dev, lib=tsl_api.lib(dev, target=target))


def load_jax_params(np_tree: dict, cfg: ArchConfig,
                    device: torch.device | str = "cuda") -> dict:
    """The reference's params as this port's params: the same nested dict
    and the same stacked (L, ...) leaves, copied 1:1 (no transposes) and
    cast to ``cfg.dtype``. Raises on a missing, extra or misshaped leaf."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    want = lm.lm_params(cfg, lambda kind, shape: tuple(shape))

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
        return torch.from_numpy(np.array(arr, np.float32)).to(device=dev, dtype=dtype)

    return convert(np_tree, want, "")
