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
_THREADS = 256
_BALLOT_ROWS = 8 * 4            # ballot body: 8 warps x 4 rows per block step
_BALLOT_BLOCKS_PER_SM = 8       # 8 x 256 threads fill an SM
_VEC_ROWS = _THREADS * 4        # vector body: the kernel's TILE (4 rows a thread)
_VEC_BLOCKS_PER_SM = 4          # the kernel's VEC_BLOCKS (its launch bounds)


@functools.cache
def _fn():
    return bind(load_shared_library("to_integral", SOURCES))


def bind(lib: ctypes.CDLL):
    """The C function of a built library, with its signature."""
    fn = lib.tsl_to_integral
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def body(m) -> str:
    """The kernel body a (rows, n) mask takes, by its shape and address:
    ``"vector"`` (16-byte loads, bits packed in registers) for n = 32 at a
    16-byte-aligned base, else ``"ballot"`` (a warp per row)."""
    return "vector" if m.shape[-1] == 32 and m.data_ptr() % 16 == 0 else "ballot"


def to_integral_2d(m, out) -> None:
    """m: contiguous (rows, n) bool / uint8 CUDA tensor, rows >= 1, 1 <= n
    <= 32; out: (rows,) uint32. Checks are the caller's (ops.to_integral).
    One launch on the current stream; raises on a refused launch."""
    rows, n = m.shape
    vec = body(m) == "vector"
    per_block, per_sm = ((_VEC_ROWS, _VEC_BLOCKS_PER_SM) if vec
                         else (_BALLOT_ROWS, _BALLOT_BLOCKS_PER_SM))
    blocks = max(1, min(cdiv(rows, per_block), sm_count(m.device) * per_sm))
    with torch.cuda.device(m.device):
        err = _fn()(m.data_ptr(), rows, n, out.data_ptr(), blocks, int(vec),
                    torch.cuda.current_stream(m.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"to_integral launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(m.device)}; m {tuple(m.shape)}, "
                           f"{body(m)} body)")
