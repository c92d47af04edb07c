"""Launchers for the hand-written CUDA C++ flash-attention kernels (see the
headers of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
for the contract, what bounds each on the H100 and what its design does
about it).

Replaces ``repro/kernels/flash_attention/kernel.py``: ``flash_attention_4d``
(the forward; with ``lse`` also ``flash_attention_fwd_4d``),
``flash_attention_bwd_dq_4d`` and ``flash_attention_bwd_dkv_4d``.
Each source is compiled by ``nvcc`` for sm_90a into a shared library with a
plain C interface at first use (``build/torch_kernels/``) and called through
``ctypes``; the C functions return ``cudaGetLastError()`` and a non-zero
code raises here.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import load_shared_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "flash_attention.cu"]
BWD_SOURCES = [CSRC / "flash_attention_bwd.cu"]
HEADERS = [CSRC / "flash_mma.cuh"]   # the bf16 tiles, copies and products both include
HEAD_DIMS = (64, 112, 128)   # the serving forward, the lse forward and the backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (B, H, KH, Sq, Sk, D, kv_len, q_offset, causal), scale, dtype, stream
_SHAPE_ARGS = [_I] * 9 + [ctypes.c_float, _I, _P]


def bind_fwd(lib: ctypes.CDLL):
    """The forward's C function of a built library, with its signature."""
    fn = lib.tsl_flash_attention_fwd
    fn.argtypes = [_P] * 5 + _SHAPE_ARGS
    fn.restype = ctypes.c_int
    return fn


def bind_bwd(lib: ctypes.CDLL):
    """(dq, dkv) C functions of a built backward library."""
    dq, dkv = lib.tsl_flash_attention_bwd_dq, lib.tsl_flash_attention_bwd_dkv
    dq.argtypes = [_P] * 7 + _SHAPE_ARGS
    dkv.argtypes = [_P] * 8 + _SHAPE_ARGS
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


@functools.cache
def _fn():
    return bind_fwd(load_shared_library("flash_attention", SOURCES))


@functools.cache
def _bwd_fns():
    return bind_bwd(load_shared_library("flash_attention_bwd", BWD_SOURCES))


def _shape_args(q, k, *, causal, scale, kv_len, q_offset):
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    return (b, h, kh, sq, sk, d, int(kv_len), int(q_offset), int(causal), float(scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _call(name, fn, q, k, ptrs, **kw) -> None:
    with torch.cuda.device(q.device):
        err = fn(*ptrs, *_shape_args(q, k, **kw))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name(q.device)}; q {tuple(q.shape)} "
            f"k {tuple(k.shape)} {q.dtype})")


def flash_attention_4d(q, k, v, out, *, causal: bool, scale: float,
                       kv_len: int, q_offset: int, lse=None) -> None:
    """q/out (B,H,Sq,D), k/v (B,KH,Sk,D): contiguous CUDA tensors of one
    dtype, already checked by the caller (ops.py); ``lse``: None (serving)
    or a contiguous (B,H,Sq) float32 output. Launches on the current stream
    and raises on a refused launch."""
    _call("flash_attention", _fn(), q, k,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr()),
          causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset)


def flash_attention_bwd_dq_4d(q, k, v, do, lse, delta, dq, *, causal: bool,
                              scale: float, kv_len: int, q_offset: int) -> None:
    """dq (B,H,Sq,D) in q's dtype from q, k, v, do and the (B,H,Sq) float32
    lse and delta; all contiguous on one card, checked by the caller."""
    _call("flash_attention_bwd_dq", _bwd_fns()[0], q, k,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr()),
          causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset)


def flash_attention_bwd_dkv_4d(q, k, v, do, lse, delta, dk, dv, *, causal: bool,
                               scale: float, kv_len: int, q_offset: int) -> None:
    """float32 dk, dv (B,H,Sk,D) per query head; as the dq launcher."""
    _call("flash_attention_bwd_dkv", _bwd_fns()[1], q, k,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
          causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset)
