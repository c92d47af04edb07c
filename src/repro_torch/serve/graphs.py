"""Captured serving steps: the port's counterpart of the reference's jitted
steps (``repro/serve/engine.py:290-371``, ``jax.jit`` with donated buffers)
and of its ``jit_cache`` report (``jit_cache_sizes``), on the shared
machinery of ``repro_torch/graphs.py`` (:class:`Step`, the runner, the
staging and :func:`disable_graphs`).

Each decode, verify, commit (lane or fused paged) and prefill-chunk step is
one :class:`Step`, keyed by its width. Donation becomes buffers updated in
place: the slot table, the page pools (int8 pools' scale pools too) and a
drafter's state stay where the graph captured them, and a batch-1 prefill
donor is staged through the step's own donor (``inout``:
copied in before the replay and out after it), so one chunk graph serves
every in-flight prefill. Every entry of one engine or drafter shares one
graph memory pool, so a step's static logits are overwritten by the next
replay of any of them: the engine consumes them (the sampler) or clones what
outlives the step before the next step runs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs import CudaGraphRunner, Step, disable_graphs
from repro_torch.kernels.paged import kernel as paged_kernel


class StepGraphs:
    """The compiled entries of one engine or drafter, keyed by (kind, key);
    on the card every entry shares one graph memory pool. ``runner`` (a
    :class:`CudaGraphRunner` on the card, None: eager on static buffers)
    is replaceable for tests."""

    def __init__(self, device: torch.device | str, runner=None):
        self.device = torch.device(device)
        if runner is None and self.device.type == "cuda":
            runner = CudaGraphRunner(self.device)
        self.runner = runner
        self.steps: dict[tuple, Step] = {}

    def step(self, kind: str, key, body, example: dict, *, inout: tuple = (),
             workspace_sizes: dict | None = None) -> Step:
        """The Step of (kind, key), made from ``body`` and ``example`` (the
        first call's arguments) on first use."""
        if (kind, key) not in self.steps:
            self.steps[kind, key] = Step(body, example, device=self.device,
                                         runner=self.runner, inout=inout,
                                         workspace_sizes=workspace_sizes)
        return self.steps[kind, key]

    def sizes(self, kinds) -> dict[str, int]:
        """Compiled entries per kind: the counterpart of the reference's
        ``jit_cache_sizes``."""
        return {kind: sum(s.entries for (k, _), s in self.steps.items() if k == kind)
                for kind in kinds}


def paged_workspace_sizes(cfg, batch: int, span: int) -> dict:
    """The fixed workspace of a fused paged step of ``span`` rows per slot:
    the paged kernel's scratch and tickets at MAX_SPLITS, so any plan fits."""
    return {"paged_attention": paged_kernel.workspace_size(
        batch, cfg.n_heads, cfg.n_kv_heads, span, cfg.hd)}


def run_model_step(graphs: StepGraphs, kind: str, model, params, state: dict,
                   tokens: np.ndarray, pos: np.ndarray, *, pools: dict | None = None,
                   tables: np.ndarray | None = None) -> torch.Tensor:
    """One decode (``kind`` "decode", tokens (B, 1)) or verify ("verify",
    tokens (B, K+1)) step of ``model`` at the (B,) per-slot positions
    ``pos``, keyed by its width: in lane mode on the slot table ``state``,
    fused paged (``pools`` and the (B, P) ``tables`` given) off the page
    pools (int8 pools with their ``{leaf}__scale`` pools beside them, which
    the step writes and reads as it does the payloads). ``state`` and
    ``pools`` are updated in place and must stay the tensors the graph
    captured. Returns the static (B, V) or (B, SV, V) logits."""
    args = {"tokens": tokens, "pos": pos}
    sizes = None
    if pools is None:
        fn = model.decode_step if kind == "decode" else model.verify_step

        def body(tokens, pos):
            return fn(params, state, tokens, pos)[0]
    else:
        fn = model.decode_step_paged if kind == "decode" else model.verify_step_paged
        args["tables"] = tables
        sizes = paged_workspace_sizes(model.cfg, tokens.shape[0], tokens.shape[1])

        def body(tokens, pos, tables):
            return fn(params, state, pools, tables, tokens, pos)[0]
    return graphs.step(kind, tokens.shape[1], body, args, workspace_sizes=sizes)(**args)


def run_prefill_chunk(graphs: StepGraphs, model, params, donor: dict,
                      tokens: np.ndarray, fill: int, n_real: int) -> torch.Tensor:
    """One prefill chunk of ``model``: tokens (1, C), the first ``n_real``
    real and the rest padding, into the batch-1 ``donor`` at cache fill
    ``fill``, the donor updated in place (staged through the step's own
    donor). ``fill`` and ``n_real`` are staged (1,) device tensors, so one
    captured chunk serves every fill and padding amount. Returns the static
    (1, C, V) logits."""
    args = {"tokens": tokens, "fill": np.asarray([fill], np.int64),
            "n_real": np.asarray([n_real], np.int64), **donor}

    def body(tokens, fill, n_real, **leaves):
        return model.prefill_chunk(params, leaves, tokens, fill, n_real=n_real)[0]
    return graphs.step("prefill_chunk", tokens.shape[1], body, args,
                       inout=tuple(donor))(**args)


def run_commit(graphs: StepGraphs, model, params, state: dict, tokens: np.ndarray,
               pos: np.ndarray, n_commit: np.ndarray, *, pools: dict | None = None,
               tables: np.ndarray | None = None) -> None:
    """The commit of a verify round (recurrent families): the span tokens
    (B, SV) at the (B,) base rows ``pos`` replayed in place, ``n_commit``
    (B,) real rows per slot (0: the slot's recurrent state is left as it
    was), keyed by the span width. In lane mode (kind "commit",
    ``model.verify_commit``) into the slot table ``state``; fused paged
    (``pools`` and the (B, P) ``tables`` given: kind "commit_paged",
    ``model.verify_commit_paged``) into the tails of ``state`` and the page
    pools, the shared attention's span rows written through the tables."""
    args = {"tokens": tokens, "pos": np.asarray(pos, np.int64),
            "n_commit": np.asarray(n_commit, np.int64)}
    kind, sizes = "commit", None
    if pools is None:
        def body(tokens, pos, n_commit):
            model.verify_commit(params, state, tokens, pos, n_commit)
            return n_commit     # the commit's result is the state, written in place
    else:
        kind = "commit_paged"
        args["tables"] = tables
        sizes = paged_workspace_sizes(model.cfg, tokens.shape[0], tokens.shape[1])

        def body(tokens, pos, n_commit, tables):
            model.verify_commit_paged(params, state, pools, tables, tokens, pos, n_commit)
            return n_commit     # tails and pools, written in place
    graphs.step(kind, tokens.shape[1], body, args, workspace_sizes=sizes)(**args)


__all__ = ["CudaGraphRunner", "Step", "StepGraphs", "disable_graphs", "paged_workspace_sizes",
           "run_commit", "run_model_step", "run_prefill_chunk"]
