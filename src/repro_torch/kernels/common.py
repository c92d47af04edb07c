"""Shared helpers for the Hopper kernels: tiling arithmetic, tensor checks,
and the ``nvcc`` build of CUDA C++ sources into shared libraries with a
plain C interface, loaded with ``ctypes``.

A shared library is built at first use from the sources in the checkout into
``build/torch_kernels/<name>_<digest>/``, where the digest hashes the
sources, the headers (``*.cuh``) beside them, the headers a kernel lists
from other directories (``headers=``, whose directories go to ``nvcc`` as
``-I``) and the compiler flags: a source or header edit rebuilds, an
unchanged checkout reuses the library. The build publishes with
``os.replace``, so a process building at the same time never loads a
half-written file. A failed build raises with the compiler's output; nothing
falls back to a plain version.

Kernels that finish a reduction across blocks in the same launch take a
scratch buffer and a ticket array from :func:`workspace`: cached per stream
for eager calls, or, inside :func:`fixed_workspaces`, the fixed buffers of
one captured step (``repro_torch/graphs.py``)."""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNEL_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[Path, ctypes.CDLL] = {}
_WORKSPACES: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_FIXED: list[dict] = []         # fixed_workspaces() stack, innermost last


def use_checkout_triton_cache() -> None:
    """Point Triton's compile cache into the checkout's build directory
    (unless the caller chose one), so building kernels writes nothing
    outside the checkout. Call before the first ``import triton``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(KERNEL_BUILD_ROOT / "triton"))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_power_of_2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (asked once per card)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of this package are built from source at first use")
    return found


def library_dir(name: str, sources: list[Path], headers: list[Path] = ()) -> Path:
    """Where ``lib<name>.so`` of ``sources`` is built: named by the digest of
    the flags, the sources, the ``*.cuh`` headers beside them and
    ``headers`` (by name and content), so an edit of any of them rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    listed = sorted({p for src in sources for p in src.parent.glob("*.cuh")} | set(headers))
    for src in [*sources, *listed]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return KERNEL_BUILD_ROOT / f"{name}_{h.hexdigest()[:12]}"


def build_shared_library(name: str, sources: list[Path], headers: list[Path] = ()) -> Path:
    """Compile ``sources`` for sm_90a into ``lib<name>.so`` in
    :func:`library_dir` (``headers``: included headers from other
    directories, each directory passed as ``-I``) and return its path. The
    compiler's output, including ``-Xptxas -v``'s registers / shared memory /
    spills per kernel, is kept beside it as ``build.log``."""
    out_dir = library_dir(name, sources, headers)
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    includes = [f"-I{d}" for d in sorted({str(Path(p).parent) for p in headers})]
    cmd = [nvcc(), *NVCC_FLAGS, *includes, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_shared_library(name: str, sources: list[Path],
                        headers: list[Path] = ()) -> ctypes.CDLL:
    """Build (once per content digest) and ``dlopen`` (once per process)."""
    path = build_shared_library(name, sources, headers)
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(str(path))
    return _LOADED[path]


def allocate_workspace(device: torch.device | str, words: int,
                       tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A workspace of ``words`` 4-byte words and ``tickets`` zeroed int32
    counters on ``device``, for :func:`fixed_workspaces`."""
    return (torch.empty(max(int(words), 1), dtype=torch.float32, device=device),
            torch.zeros(max(int(tickets), 1), dtype=torch.int32, device=device))


@contextlib.contextmanager
def fixed_workspaces(spaces: dict):
    """Hand the kernels launched inside the fixed workspaces of one captured
    step: ``spaces`` maps a kernel name to its (scratch, tickets). A kernel
    whose name is missing gets one allocated into ``spaces`` at its first
    request, which must come before capture (a warm-up call). A buffer is
    never grown or replaced, so a graph that captured it keeps pointing at
    live memory; a request it cannot hold raises."""
    _FIXED.append(spaces)
    try:
        yield spaces
    finally:
        _FIXED.pop()


def workspace(name: str, device: torch.device, words: int,
              tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch for kernel ``name`` on ``device``: at least ``words`` 4-byte
    words (float32 storage, any 4-byte type to the kernel) and ``tickets``
    int32 counters, zeroed when allocated; sized from shapes only, never
    from data on the device. A kernel that takes tickets leaves every one
    at 0 when it finishes.

    Inside :func:`fixed_workspaces` it is the captured step's own buffer.
    Otherwise it is cached per (kernel, device, stream) and grown, never
    shrunk, so repeated eager calls at one shape allocate nothing. Growing
    frees the old buffer, which a graph could still point at, and a cached
    buffer is shared by every call on its stream: so outside a fixed
    workspace this raises while the current stream is capturing."""
    capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if _FIXED:
        spaces = _FIXED[-1]
        if name not in spaces:
            if capturing:
                raise RuntimeError(f"workspace({name!r}) first requested while capturing: "
                                   f"a captured step's workspace is allocated before "
                                   f"capture (warm-up, or sized from its shapes)")
            spaces[name] = allocate_workspace(device, words, tickets)
        ws, ct = spaces[name]
        if ws.numel() < words or ct.numel() < tickets or ws.device.type != device.type:
            raise ValueError(f"fixed workspace of {name!r} holds {ws.numel()} words and "
                             f"{ct.numel()} tickets on {ws.device}; the launch needs "
                             f"{words} and {tickets} on {device}")
        return ws, ct
    if capturing:
        raise RuntimeError(f"workspace({name!r}) called while the stream is capturing: "
                           f"hand the captured kernels a fixed workspace "
                           f"(common.fixed_workspaces)")
    key = (name, device.index, torch.cuda.current_stream(device).cuda_stream)
    ws, ct = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < words:
        ws = torch.empty(max(words, 1), dtype=torch.float32, device=device)
    if ct is None or ct.numel() < tickets:
        ct = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _WORKSPACES[key] = (ws, ct)
    return ws, ct
