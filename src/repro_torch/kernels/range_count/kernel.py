"""Launcher for the hand-written CUDA C++ range count
(``csrc/range_count.cu``; see its header for the contract, what bounds it on
the H100 and what its design does about it).

Replaces ``repro/kernels/range_count/kernel.py:range_count_2d``. The source
is compiled by ``nvcc`` for sm_90a into a shared library with a plain C
interface at first use (``build/torch_kernels/``) and called through
``ctypes``; the C function returns ``cudaGetLastError()`` and a non-zero
code raises here.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import cdiv, load_shared_library, sm_count

SOURCES = [Path(__file__).resolve().parent / "csrc" / "range_count.cu"]
_THREADS, _UNROLL = 256, 4          # the kernel's NT and UNROLL
_BLOCKS_PER_SM = 8                  # 8 x 256 threads fill an SM


@functools.cache
def _fn():
    lib = load_shared_library("range_count", SOURCES)
    fn = lib.tsl_range_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_blocks(n: int, device: torch.device) -> int:
    """Blocks of the grid-stride loop: enough to cover n once, at most
    _BLOCKS_PER_SM per SM."""
    sms = sm_count(device)
    return max(1, min(cdiv(cdiv(n, 4), _THREADS * _UNROLL), sms * _BLOCKS_PER_SM))


def range_count_1d(x, count, *, lo, hi) -> None:
    """x: contiguous 1-D float32 / int32 CUDA tensor of n >= 1 elements;
    lo, hi: a Python float (compared in float32) or, on int32 data, an int
    in int32's range (compared exactly); count: a 0-d int32 CUDA tensor the
    C function zeroes and the kernel adds into. Checks are the caller's
    (ops.range_count). Launches on the current stream and raises on a
    refused launch."""
    n = x.numel()
    lo_f, hi_f = isinstance(lo, float), isinstance(hi, float)
    mode = 6 if x.dtype == torch.float32 else 1 | (2 * lo_f) | (4 * hi_f)
    flo, fhi = (float(lo) if lo_f else 0.0), (float(hi) if hi_f else 0.0)
    ilo, ihi = (0 if lo_f else int(lo)), (0 if hi_f else int(hi))
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), n, mode, flo, fhi, ilo, ihi, count.data_ptr(),
                    grid_blocks(n, x.device),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"range_count launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(x.device)}; n {n} {x.dtype} "
                           f"mode {mode})")
