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
scratch buffer and a ticket array from :func:`workspace`."""

from __future__ import annotations

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


def workspace(name: str, device: torch.device, words: int,
              tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch for kernel ``name`` on ``device`` and the current stream: at
    least ``words`` 4-byte words (float32 storage, any 4-byte type to the
    kernel) and ``tickets`` int32 counters, zeroed when allocated. Cached per
    (kernel, device, stream) and grown, never shrunk, so repeated calls at
    one shape allocate nothing; sized from shapes only, never from data on
    the device. A kernel that takes tickets leaves every one at 0 when it
    finishes. Not safe under CUDA graphs: growing frees the old buffer that
    a graph captured earlier still points at, and a graph replayed on
    another stream shares its scratch and tickets with eager calls on its
    capture stream. A captured step needs a fixed workspace of its own
    (ROADMAP queue 1, item 4)."""
    key = (name, device.index, torch.cuda.current_stream(device).cuda_stream)
    ws, ct = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < words:
        ws = torch.empty(max(words, 1), dtype=torch.float32, device=device)
    if ct is None or ct.numel() < tickets:
        ct = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _WORKSPACES[key] = (ws, ct)
    return ws, ct
