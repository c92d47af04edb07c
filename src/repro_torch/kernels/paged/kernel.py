"""Launcher for the hand-written CUDA C++ block-table attention
(``csrc/paged_attention.cu``; see its header for the contract, what bounds
it on the H100 and what its design does about it).

Replaces ``repro/kernels/paged/kernel.py:paged_attention_4d``. The source is
compiled by ``nvcc`` for sm_90a into a shared library with a plain C
interface at first use (``build/torch_kernels/``), with the flash kernels'
``flash_mma.cuh`` on its include path, and called through ``ctypes``; the C
function returns ``cudaGetLastError()`` and a non-zero code raises here. A
page id outside the pool, or a ``kv_len`` beyond the table's coverage, trips
a device-side assert (reported at the next synchronise).

One launch per call: the keys of each (sequence, KV head) are split over
``splits`` blocks of ``pps`` table entries each (:func:`plan`), and the last
block of each merges the splits inside the same launch, through a workspace
(``common.workspace``: cached per device and stream for eager calls; a
captured step hands it a fixed one sized by :func:`workspace_size` for
MAX_SPLITS, so any plan fits).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..common import cdiv, load_shared_library, workspace

SOURCES = [Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"]
HEADERS = [Path(__file__).resolve().parents[1] / "flash_attention" / "csrc" / "flash_mma.cuh"]
HEAD_DIMS = (64, 112, 128)
MAX_ROWS = 64               # group * SQ query rows one block holds
MAX_SPLITS = 64             # splits per (sequence, KV head)
KEY_TILE = 64               # keys per tile of the bf16 path
_BLOCKS_PER_SM = 2          # the plan's target: about 2 blocks per SM in all
_MIN_SPLIT_KEYS = 256       # fewest keys of a split (4 tiles): a split costs a merge
_TILE_BYTES = 16384         # float32 path: K (and V) bytes of one tile at most
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tile_rows(dtype: torch.dtype, head_dim: int) -> int:
    """Most key rows one tile of the float32 path holds (its ``tile_rows<D>``):
    64, or the largest power of two whose tile stays within _TILE_BYTES (32 at
    D 112 and 128); the bf16 path takes 64-key tiles."""
    rows = 64
    while rows * head_dim * dtype.itemsize > _TILE_BYTES:
        rows //= 2
    return rows


def plan(b: int, kh: int, table_width: int, page: int, sms: int) -> tuple[int, int]:
    """(splits, pps): the keys of each (sequence, KV head) go to ``splits``
    blocks, split s reading table entries [s*pps, (s+1)*pps). Enough splits
    that the b*kh*splits blocks give every one of the ``sms`` SMs about
    _BLOCKS_PER_SM of them, but no more than leave each split
    _MIN_SPLIT_KEYS keys of a full table, and at most MAX_SPLITS; every table
    entry falls in exactly one split and none starts past the table. A
    function of the shapes and the card only: kv_len stays on the device."""
    want = cdiv(sms * _BLOCKS_PER_SM, b * kh)
    splits = max(1, min(want, table_width * page // _MIN_SPLIT_KEYS, MAX_SPLITS))
    pps = cdiv(table_width, splits)
    return cdiv(table_width, pps), pps


def workspace_size(b: int, h: int, kh: int, sq: int, d: int,
                   splits: int = MAX_SPLITS) -> tuple[int, int]:
    """(scratch words, tickets) of a launch on q (b, h, sq, d) over ``kh`` KV
    heads with ``splits`` splits: each split of each (sequence, KV head)
    leaves acc, m and l of its group * sq rows, D + 4 words a row (the
    kernel's ``part_floats``); one ticket per (sequence, KV head). The
    default covers every plan."""
    return b * kh * splits * (h // kh) * sq * (d + 4), b * kh


def bind(lib: ctypes.CDLL):
    """The C function of a built library, with its signature."""
    fn = lib.tsl_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(load_shared_library("paged_attention", SOURCES, HEADERS))


def paged_attention_4d(q, k_pool, v_pool, tables, kv_len, out, *, tile: int, scale: float,
                       splits: int, pps: int) -> None:
    """q/out (B,H,SQ,D); pools (KH,n_pages,page,D); tables (B,P) int32;
    kv_len (B,) int32: contiguous CUDA tensors already checked by the caller
    (ops.paged_attention). ``tile`` key rows per float32 tile divide the
    page; ``(splits, pps)`` from :func:`plan`. Launches once on the current
    stream and raises on a refused launch."""
    b, h, sq, d = q.shape
    kh, n_pages, page, _ = k_pool.shape
    ws = counters = None
    if splits > 1:
        ws, counters = workspace("paged_attention", q.device,
                                 *workspace_size(b, h, kh, sq, d, splits))
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    None if counters is None else counters.data_ptr(), b, h, kh, sq, d,
                    n_pages, page, tables.shape[1], int(tile), int(splits), int(pps),
                    float(scale), _DTYPE_CODE[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name(q.device)}; q {tuple(q.shape)} "
            f"pool {tuple(k_pool.shape)} tables {tuple(tables.shape)} {q.dtype}, "
            f"splits {splits} x {pps} entries)")
