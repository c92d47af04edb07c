"""Shared helpers for the Hopper kernels: tiling arithmetic, tensor checks,
and the ``nvcc`` build of CUDA C++ sources into shared libraries with a
plain C interface, loaded with ``ctypes``.

A shared library is built at first use from the sources in the checkout into
``build/torch_kernels/<name>_<digest>/``, where the digest hashes the
sources, the headers (``*.cuh``) beside them and the compiler flags: a
source or header edit rebuilds, an unchanged
checkout reuses the library. The build publishes with ``os.replace``, so a
process building at the same time never loads a half-written file. A failed build raises
with the compiler's output; nothing falls back to a plain version."""

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


def build_shared_library(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` for sm_90a into ``lib<name>.so`` (cached by
    the digest of the sources and the ``*.cuh`` headers beside them) and
    return its path. The compiler's output, including
    ``-Xptxas -v``'s registers / shared memory / spills per kernel, is kept
    beside it as ``build.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({p for src in sources for p in src.parent.glob("*.cuh")})
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = KERNEL_BUILD_ROOT / f"{name}_{h.hexdigest()[:12]}"
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_shared_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Build (once per content digest) and ``dlopen`` (once per process)."""
    path = build_shared_library(name, sources)
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(str(path))
    return _LOADED[path]
