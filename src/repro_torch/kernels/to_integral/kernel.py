"""Launcher for the hand-written CUDA C++ movemask
(``csrc/to_integral.cu``; see its header for the contract, what bounds it
on the H100 and what its design does about it).

Replaces ``repro/kernels/to_integral/kernel.py:to_integral_2d``. The source
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

SOURCES = [Path(__file__).resolve().parent / "csrc" / "to_integral.cu"]
_WARPS, _ROWS = 8, 4            # the kernel's NW and ROWS
_BLOCKS_PER_SM = 8              # 8 x 256 threads fill an SM


@functools.cache
def _fn():
    lib = load_shared_library("to_integral", SOURCES)
    fn = lib.tsl_to_integral
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def to_integral_2d(m, out) -> None:
    """m: contiguous (rows, n) bool / uint8 CUDA tensor, rows >= 1, 1 <= n
    <= 32; out: (rows,) uint32. Checks are the caller's (ops.to_integral).
    Launches on the current stream and raises on a refused launch."""
    rows, n = m.shape
    sms = sm_count(m.device)
    blocks = max(1, min(cdiv(rows, _WARPS * _ROWS), sms * _BLOCKS_PER_SM))
    with torch.cuda.device(m.device):
        err = _fn()(m.data_ptr(), rows, n, out.data_ptr(), blocks,
                    torch.cuda.current_stream(m.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"to_integral launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(m.device)}; m {tuple(m.shape)})")
