"""Launcher for the hand-written CUDA C++ block-table attention
(``csrc/paged_attention.cu``; see its header for the contract, what bounds
it on the H100 and what its design does about it).

Replaces ``repro/kernels/paged/kernel.py:paged_attention_4d``. The source is
compiled by ``nvcc`` for sm_90a into a shared library with a plain C
interface at first use (``build/torch_kernels/``) and called through
``ctypes``; the C function returns ``cudaGetLastError()`` and a non-zero code
raises here. A page id outside the pool, or a ``kv_len`` beyond the table's
coverage, trips a device-side assert (reported at the next synchronise).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import load_shared_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"]
HEAD_DIMS = (64, 128)
MAX_ROWS = 64               # group * SQ query rows one block holds
_TILE_BYTES = 16384         # K (and V) bytes of one tile at most
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tile_rows(dtype: torch.dtype, head_dim: int) -> int:
    """Most key rows one tile of the kernel holds (its ``tile_rows<T, D>``)."""
    return min(64, _TILE_BYTES // (head_dim * dtype.itemsize))


@functools.cache
def _fn():
    lib = load_shared_library("paged_attention", SOURCES)
    fn = lib.tsl_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention_4d(q, k_pool, v_pool, tables, kv_len, out, *, tile: int,
                       scale: float) -> None:
    """q/out (B,H,SQ,D); pools (KH,n_pages,page,D); tables (B,P) int32;
    kv_len (B,) int32: contiguous CUDA tensors already checked by the caller
    (ops.paged_attention). ``tile`` key rows per tile divide the page.
    Launches on the current stream and raises on a refused launch."""
    b, h, sq, d = q.shape
    kh, n_pages, page, _ = k_pool.shape
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(), b, h, kh, sq, d, n_pages, page,
                    tables.shape[1], int(tile), float(scale), _DTYPE_CODE[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name(q.device)}; q {tuple(q.shape)} "
            f"pool {tuple(k_pool.shape)} tables {tuple(tables.shape)} {q.dtype})")
