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

from ..common import cdiv, load_shared_library, sm_count

SOURCES = [Path(__file__).resolve().parent / "csrc" / "hadd.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
ACC_DTYPE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
             torch.int32: torch.int32}
WARP_ROW_MAX = 1024         # rows up to this long: a warp per row
_MIN_CHUNK = 4096           # fewest columns one block of a split row sums
_BLOCKS_PER_SM = 8          # 8 blocks of 256 threads fill an SM
_MAX_SPLITS = 65535         # grid.y


@functools.cache
def _fn():
    lib = load_shared_library("hadd", SOURCES)
    fn = lib.tsl_hadd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(rows: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): splits 0 is a warp per row; else each row is cut
    into ``splits`` slices of ``chunk`` columns (a multiple of 8), enough
    slices over all rows to give every SM _BLOCKS_PER_SM blocks where the
    rows are long enough."""
    if n <= WARP_ROW_MAX:
        return 0, 0
    splits = max(1, min(cdiv(sms * _BLOCKS_PER_SM, rows), cdiv(n, _MIN_CHUNK), _MAX_SPLITS))
    chunk = cdiv(cdiv(n, splits), 8) * 8
    return cdiv(n, chunk), chunk


def hadd_2d(x, out) -> None:
    """x: contiguous (rows, n) CUDA tensor, rows, n >= 1; out: (rows,) of
    x's dtype. Checks are the caller's (ops.hadd). Launches on the current
    stream (a second launch adds the partials of split rows) and raises on a
    refused launch."""
    rows, n = x.shape
    sms = sm_count(x.device)
    splits, chunk = plan(rows, n, sms)
    partial = (torch.empty(rows * splits, dtype=ACC_DTYPE[x.dtype], device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), rows, n, _DTYPE_CODE[x.dtype], splits, chunk,
                    partial.data_ptr() if partial is not None else None, out.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hadd launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(x.device)}; x {tuple(x.shape)} "
                           f"{x.dtype}, splits {splits}, chunk {chunk})")
