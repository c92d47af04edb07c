"""Launcher for the hand-written CUDA C++ flash-attention forward
(``csrc/flash_attention.cu``; see its header for the contract, what bounds
it on the H100 and what its design does about it).

Replaces ``repro/kernels/flash_attention/kernel.py:flash_attention_4d``.
The source is compiled by ``nvcc`` for sm_90a into a shared library with a
plain C interface at first use (``build/torch_kernels/``) and called through
``ctypes``; the C function returns ``cudaGetLastError()`` and a non-zero
code raises here.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import load_shared_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    lib = load_shared_library("flash_attention", SOURCES)
    fn = lib.tsl_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_4d(q, k, v, out, *, causal: bool, scale: float,
                       kv_len: int, q_offset: int) -> None:
    """q/out (B,H,Sq,D), k/v (B,KH,Sk,D): contiguous CUDA tensors of one
    dtype, already checked by the caller (ops.flash_attention). Launches on
    the current stream and raises on a refused launch."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, kh, sq, sk, d, int(kv_len), int(q_offset), int(causal),
                    float(scale), _DTYPE_CODE[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name(q.device)}; q {tuple(q.shape)} "
            f"k {tuple(k.shape)} {q.dtype})")
