"""Captured serving steps: the port's counterpart of the reference's jitted
steps (``repro/serve/engine.py:290-371``, ``jax.jit`` with donated buffers)
and of its ``jit_cache`` report (``jit_cache_sizes``).

A :class:`Step` is one compiled entry: a step body at fixed shapes over
static input buffers. On the card its first call runs the body once on a
side stream (the warm-up: a real step, whose launches count as eager ones;
Triton compiles and the CUDA libraries load here), then captures it in one
CUDA graph in the owner's memory pool; every later call stages its host data
into the static buffers (small copies from pinned memory) and replays.
Donation becomes buffers updated in place: the slot table, the page pools
and a drafter's state stay where the graph captured them, and a batch-1
prefill donor is staged through the step's own donor (copied in before the
replay and out after it), so one chunk graph serves every in-flight prefill.

The static output is overwritten by the next replay of any graph of the same
pool: a caller consumes it (the sampler) or clones what outlives the step
before the next step runs. Every replay adds to each kernel's launch counter
what its capture recorded, so the counters mean what they mean eagerly. A
captured kernel that merges splits in the same launch takes the step's fixed
workspace (``kernels/common.fixed_workspaces``), allocated before capture.

On the CPU the same object runs the body eagerly against the same static
buffers, copies its output into a static output, and counts the entry it
would capture: the staging, the keying and the aliasing of the static output
are the card's. :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``) runs the bodies eagerly on the caller's tensors, op by
op; it is the only way to run eagerly on the card. A capture or replay that
fails raises; nothing falls back.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import launch_counters
from repro_torch.kernels.common import allocate_workspace, fixed_workspaces
from repro_torch.kernels.paged import kernel as paged_kernel

_ENABLED = {"graphs": True}


@contextlib.contextmanager
def disable_graphs():
    """Run every step eagerly, op by op, on the caller's tensors, as
    ``jax.disable_jit()`` runs jitted functions (nested calls restore the
    outer setting)."""
    prev = _ENABLED["graphs"]
    _ENABLED["graphs"] = False
    try:
        yield
    finally:
        _ENABLED["graphs"] = prev


class CudaGraphRunner:
    """Warm-up and capture on one side stream, into one graph memory pool
    shared by every step of the owner; replays on the current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def side_stream(self):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def capture(self, fn):
        """(graph, fn's output) with fn captured, not run. Unlike the
        ``torch.cuda.graph`` context this does not empty the allocator's
        cache first, which took most of a capture's host time."""
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


def _torch_dtype(value) -> torch.dtype:
    if isinstance(value, torch.Tensor):
        return value.dtype
    return torch.from_numpy(np.empty(0, np.asarray(value).dtype)).dtype


def _stage(buf: torch.Tensor, value) -> None:
    """Copy a host array (through pinned memory on the card, without
    waiting) or a device tensor into the static buffer ``buf``."""
    if isinstance(value, torch.Tensor):
        src = value
    else:
        src = torch.from_numpy(np.ascontiguousarray(value)).to(buf.dtype)
        if buf.device.type == "cuda":
            src = src.pin_memory()
    if tuple(src.shape) != tuple(buf.shape):
        raise ValueError(f"step input of shape {tuple(src.shape)} staged into a static "
                         f"buffer of {tuple(buf.shape)}")
    buf.copy_(src, non_blocking=buf.device.type == "cuda")


class Step:
    """One compiled entry: ``body(**inputs) -> tensor`` at the shapes and
    dtypes of ``example`` (host arrays, or device tensors for ``inout``
    buffers, which the body updates in place and are copied back to the
    caller's after each call). ``workspace_sizes``: {kernel: (words,
    tickets)} of the fixed workspaces its kernels take."""

    def __init__(self, body, example: dict, *, device: torch.device, runner=None,
                 inout: tuple = (), workspace_sizes: dict | None = None):
        self.body = body
        self.device = device
        self.runner = runner
        self.inout = tuple(inout)
        self.specs = {n: (tuple(v.shape), _torch_dtype(v)) for n, v in example.items()}
        self.workspace_sizes = dict(workspace_sizes or {})
        self.inputs: dict[str, torch.Tensor] | None = None
        self.workspaces: dict = {}
        self.output: torch.Tensor | None = None
        self.graph = None
        self.entries = 0            # 1 once compiled (captured, on the card)
        self.launches: dict[str, int] = {}   # recorded per replay, by counter
        self.replays = 0

    def __call__(self, **args) -> torch.Tensor:
        if set(args) != set(self.specs):
            raise ValueError(f"step inputs {sorted(args)} != {sorted(self.specs)}")
        if not _ENABLED["graphs"]:
            return self.body(**{n: v if isinstance(v, torch.Tensor)
                                else torch.as_tensor(v, device=self.device)
                                for n, v in args.items()})
        if self.inputs is None:
            self.inputs = {n: torch.zeros(shape, dtype=dt, device=self.device)
                           for n, (shape, dt) in self.specs.items()}
            self.workspaces = {n: allocate_workspace(self.device, *size)
                               for n, size in self.workspace_sizes.items()}
        for n, v in args.items():
            _stage(self.inputs[n], v)
        if self.runner is None:
            self._run_eagerly()
        elif self.graph is None:
            self._capture()
        else:
            self.runner.replay(self.graph)
            self.replays += 1
            counters = launch_counters()
            for n, k in self.launches.items():
                counters[n].launches += k
        for n in self.inout:
            args[n].copy_(self.inputs[n])
        return self.output

    def _run_eagerly(self) -> None:
        with fixed_workspaces(self.workspaces):
            out = self.body(**self.inputs)
        if self.output is None:
            self.output = out.clone()
            self.entries = 1
        else:
            self.output.copy_(out)

    def _capture(self) -> None:
        counters = launch_counters()
        with self.runner.side_stream(), fixed_workspaces(self.workspaces):
            warm = self.body(**self.inputs)
            before = {n: fn.launches for n, fn in counters.items()}
            try:
                self.graph, self.output = self.runner.capture(
                    lambda: self.body(**self.inputs))
                self.launches = {n: fn.launches - before[n] for n, fn in counters.items()
                                 if fn.launches != before[n]}
            finally:
                # the capture ran no kernel: its counts come back on replay
                for n, fn in counters.items():
                    fn.launches = before[n]
            self.output.copy_(warm)
        self.entries = 1


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
    pools. ``state`` and ``pools`` are updated in place and must stay the
    tensors the graph captured. Returns the static (B, V) or (B, SV, V)
    logits."""
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
                      tokens: np.ndarray, fill: int) -> torch.Tensor:
    """One prefill chunk of ``model``: tokens (1, C) into the batch-1
    ``donor`` at cache fill ``fill``, the donor updated in place (staged
    through the step's own donor). Returns the static (1, C, V) logits."""
    args = {"tokens": tokens, "fill": np.asarray([fill], np.int64), **donor}

    def body(tokens, fill, **leaves):
        return model.prefill_chunk(params, leaves, tokens, fill)[0]
    return graphs.step("prefill_chunk", tokens.shape[1], body, args,
                       inout=tuple(donor))(**args)


__all__ = ["CudaGraphRunner", "Step", "StepGraphs", "disable_graphs", "paged_workspace_sizes",
           "run_model_step", "run_prefill_chunk"]
