"""Compiled steps: the port's counterpart of ``jax.jit`` with donated
buffers, shared by serving (``serve/graphs.py``) and training
(``train/graphs.py``).

A :class:`Step` is one compiled entry: a step body at fixed shapes over
static input buffers and, optionally, buffers it owns (donated). On the card
its first call runs the body once on a side stream (the warm-up: a real
step, whose launches count as eager ones; Triton compiles and the CUDA
libraries load here), then captures it in one CUDA graph in the owner's
memory pool; every later call stages its host data into the static buffers
(small copies from pinned memory) and replays. Donation becomes buffers
updated in place: a donated buffer is the graph's own and is never copied;
an ``inout`` buffer is staged through the step's own copy (copied in before
the replay and out after it), so one graph serves several callers' buffers.

The static outputs (one tensor, or a dict of them) are overwritten by the
next replay of any graph of the same pool: a caller consumes them or clones
what outlives the step before the next step runs. Every replay adds to each
kernel's launch counter what its capture recorded, so the counters mean
what they mean eagerly. A captured kernel that merges splits in the same
launch takes the step's fixed workspace (``kernels/common.fixed_workspaces``),
allocated before capture.

On the CPU the same object runs the body eagerly against the same static
buffers and copies its output into static outputs: the staging, the keying,
the donation and the aliasing of the static outputs are the card's.
:func:`disable_graphs` (the counterpart of ``jax.disable_jit()``) runs the
bodies eagerly on the caller's tensors, op by op; it is the only way to run
eagerly on the card. A capture or replay that fails raises; nothing falls
back.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.kernels import launch_counters
from repro_torch.kernels.common import allocate_workspace, fixed_workspaces

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


def graphs_enabled() -> bool:
    return _ENABLED["graphs"]


class CudaGraphRunner:
    """Warm-up and capture on one side stream, into one graph memory pool
    shared by every step of the owner; replays on the current stream.
    ``release_cache``: hand the allocator's cached blocks (the warm-up's
    freed activations) back to the device before each capture, so the pool
    does not reserve a second copy of them beside the cache."""

    def __init__(self, device: torch.device, release_cache: bool = False):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.release_cache = release_cache

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
        cache first (unless ``release_cache``), which took most of a serving
        step's capture host time."""
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        if self.release_cache:
            torch.cuda.empty_cache()
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


def _clone_out(out):
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()


def _copy_out(static, out) -> None:
    if isinstance(static, dict):
        for k, v in static.items():
            v.copy_(out[k])
    else:
        static.copy_(out)


class Step:
    """One compiled entry: ``body(**inputs, **donated) -> tensor or dict of
    tensors`` at the shapes and dtypes of ``example`` (host arrays, or
    device tensors for ``inout`` buffers, which the body updates in place and
    are copied back to the caller's after each call). ``donated``: {name:
    tensor or nested dict of tensors} the step owns, handed to the body as
    they are and updated by it in place; never staged and never copied.
    ``workspace_sizes``: {kernel: (words, tickets)} of the fixed workspaces
    its kernels take."""

    def __init__(self, body, example: dict, *, device: torch.device, runner=None,
                 inout: tuple = (), donated: dict | None = None,
                 workspace_sizes: dict | None = None):
        self.body = body
        self.device = device
        self.runner = runner
        self.inout = tuple(inout)
        self.donated = dict(donated or {})
        self.specs = {n: (tuple(v.shape), _torch_dtype(v)) for n, v in example.items()}
        self.workspace_sizes = dict(workspace_sizes or {})
        self.inputs: dict[str, torch.Tensor] | None = None
        self.workspaces: dict = {}
        self.output = None          # a tensor, or a dict of them, as the body returns
        self.graph = None
        self.entries = 0            # 1 once compiled (captured, on the card)
        self.launches: dict[str, int] = {}   # recorded per replay, by counter
        self.replays = 0
        self.capture_s = 0.0        # host seconds of the capture (the warm-up not included)

    def __call__(self, **args):
        if set(args) != set(self.specs):
            raise ValueError(f"step inputs {sorted(args)} != {sorted(self.specs)}")
        if not _ENABLED["graphs"]:
            return self.body(**{n: v if isinstance(v, torch.Tensor)
                                else torch.as_tensor(v, device=self.device)
                                for n, v in args.items()}, **self.donated)
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
            out = self.body(**self.inputs, **self.donated)
        if self.output is None:
            self.output = _clone_out(out)
            self.entries = 1
        else:
            _copy_out(self.output, out)

    def _capture(self) -> None:
        counters = launch_counters()
        with self.runner.side_stream(), fixed_workspaces(self.workspaces):
            warm = self.body(**self.inputs, **self.donated)
            before = {n: fn.launches for n, fn in counters.items()}
            t0 = time.perf_counter()
            try:
                self.graph, self.output = self.runner.capture(
                    lambda: self.body(**self.inputs, **self.donated))
                self.launches = {n: fn.launches - before[n] for n, fn in counters.items()
                                 if fn.launches != before[n]}
            finally:
                # the capture ran no kernel: its counts come back on replay
                for n, fn in counters.items():
                    fn.launches = before[n]
            self.capture_s = time.perf_counter() - t0
            _copy_out(self.output, warm)
        self.entries = 1


__all__ = ["CudaGraphRunner", "Step", "disable_graphs", "graphs_enabled"]
