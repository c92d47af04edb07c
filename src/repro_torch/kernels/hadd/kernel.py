"""Launcher for the hand-written CUDA C++ horizontal add
(``csrc/hadd.cu``; see its header for the contract, what bounds it on the
H100 and what its design does about it).

Replaces ``repro/kernels/hadd/kernel.py:hadd_2d``. The source is compiled by
``nvcc`` for sm_90a into a shared library with a plain C interface at first
use (``build/torch_kernels/``) and called through ``ctypes``; the C function
returns ``cudaGetLastError()`` and a non-zero code raises here.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import cdiv, load_shared_library, sm_count, workspace

SOURCES = [Path(__file__).resolve().parent / "csrc" / "hadd.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
WARP_ROW_MAX = 1024         # rows up to this long: a warp per row
_MIN_PER_BLOCK = 8192       # fewest elements one block of a split row sums
_BLOCKS_PER_SM = 4          # resident blocks of 256 threads (the kernel's launch bounds)
_MAX_SPLITS = 65535         # grid.y


@functools.cache
def _fn():
    return bind(load_shared_library("hadd", SOURCES))


def bind(lib: ctypes.CDLL):
    """The C function of a built library, with its signature."""
    fn = lib.tsl_hadd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(rows: int, n: int, sms: int) -> int:
    """Blocks per row: 0 is a warp per row; else ``splits`` blocks stride
    over each row, as many over all rows as the card holds at once
    (_BLOCKS_PER_SM per SM) where the rows are long enough, each at least
    _MIN_PER_BLOCK elements. A function of the shape and the card only."""
    if n <= WARP_ROW_MAX:
        return 0
    return max(1, min(cdiv(sms * _BLOCKS_PER_SM, rows), cdiv(n, _MIN_PER_BLOCK), _MAX_SPLITS))


def hadd_2d(x, out) -> None:
    """x: contiguous (rows, n) CUDA tensor, rows, n >= 1; out: (rows,) of
    x's dtype. Checks are the caller's (ops.hadd). One launch on the current
    stream (the last block of a split row adds its partials); raises on a
    refused launch."""
    rows, n = x.shape
    splits = plan(rows, n, sm_count(x.device))
    partial = tickets = None
    if splits > 1:
        partial, tickets = workspace("hadd", x.device, rows * splits, rows)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), rows, n, _DTYPE_CODE[x.dtype], splits,
                    None if partial is None else partial.data_ptr(),
                    None if tickets is None else tickets.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hadd launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(x.device)}; x {tuple(x.shape)} "
                           f"{x.dtype}, splits {splits})")
