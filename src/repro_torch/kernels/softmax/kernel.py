"""Launcher for the hand-written CUDA C++ row softmax (``csrc/softmax.cu``;
see its header for the contract, what bounds it on the H100 and what its
design does about it).

Replaces ``repro/kernels/softmax/kernel.py:softmax_2d``. The source is
compiled by ``nvcc`` for sm_90a into a shared library with a plain C
interface at first use (``build/torch_kernels/``) and called through
``ctypes``; the C function returns ``cudaGetLastError()`` (or the cluster
launch's own error) and a non-zero code raises here, with the card, the
shape and the plan. Nothing gives way to another kernel or to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from ..common import cdiv, load_shared_library, next_power_of_2, sm_count

SOURCES = [Path(__file__).resolve().parent / "csrc" / "softmax.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_REGIME_CODE = {"narrow": 0, "wide": 1, "stream": 2}
NARROW_MAX = 1024           # rows up to this wide: a warp per row, in registers
SMEM_BUDGET = 224 * 1024    # shared memory a wide chunk may take (softmax.cu SMEM_MAX)
MIN_CHUNK = 2048            # fewest elements a CTA of a cluster takes
MAX_CLUSTER = 16            # CTAs per row at most: non-portable above 8
PORTABLE_CLUSTER = 8


class Plan(NamedTuple):
    """How one call runs. ``regime``: "narrow" (a warp per row), "wide" (a
    cluster of ``cluster`` CTAs per row, each chunk in ``smem`` bytes of
    shared memory) or "stream" (the same cluster streaming its chunk);
    ``chunk``: elements per CTA, ``chunks``: the bounds [c0, c1) of each
    CTA's chunk of a row, in rank order; ``lane``: elements a lane holds
    (narrow only); ``load``: "bulk" (cp.async.bulk), "vector" (16-byte
    loads) or "element"."""
    regime: str
    cluster: int
    chunk: int
    chunks: tuple
    lane: int
    smem: int
    load: str


def plan(rows: int, d: int, itemsize: int, sms: int, aligned: bool = True,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The plan of a (rows, d) call: a function of the shape, the element
    size, the card (``sms``; ``max_cluster``, the largest cluster it admits)
    and whether both bases are 16-byte aligned, never of the data. A narrow
    row (d <= NARROW_MAX) goes to one warp; a wider one to a cluster of up
    to ``max_cluster`` CTAs, as many as fill the card over all rows but each
    with MIN_CHUNK elements at least, its chunks cut on whole 16-byte
    vectors and none empty. A chunk larger than SMEM_BUDGET streams."""
    vec = aligned and d * itemsize % 16 == 0
    per_vec = 16 // itemsize
    if d <= NARROW_MAX:
        lane = max(4, next_power_of_2(cdiv(d, 32)))
        vec = vec and lane >= per_vec
        return Plan("narrow", 1, d, ((0, d),), lane, 0, "vector" if vec else "element")
    cluster = max(1, min(max_cluster, cdiv(d, MIN_CHUNK), cdiv(sms, rows)))
    chunk = cdiv(cdiv(d, cluster), per_vec) * per_vec
    cluster = cdiv(d, chunk)                # no empty chunk
    chunks = tuple((r * chunk, min((r + 1) * chunk, d)) for r in range(cluster))
    if chunk * itemsize > SMEM_BUDGET:
        return Plan("stream", cluster, chunk, chunks, 0, 0, "vector" if vec else "element")
    return Plan("wide", cluster, chunk, chunks, 0, chunk * itemsize,
                "bulk" if vec else "element")


@functools.cache
def _lib():
    return load_shared_library("softmax", SOURCES)


@functools.cache
def _fn():
    return bind(_lib())


def bind(lib: ctypes.CDLL):
    """The C function of a built library, with its signature."""
    fn = lib.tsl_softmax
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_cluster(index: int, dtype: torch.dtype) -> int:
    """The largest cluster the card ``index`` holds at the full shared-memory
    budget: MAX_CLUSTER where cudaOccupancyMaxActiveClusters admits it, else
    PORTABLE_CLUSTER; raises where it admits neither. Asked once per card
    and dtype."""
    fn = _lib().tsl_softmax_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    found = {}
    with torch.cuda.device(index):
        for size in (MAX_CLUSTER, PORTABLE_CLUSTER):
            count = ctypes.c_int(0)
            err = fn(_DTYPE_CODE[dtype], size, SMEM_BUDGET, ctypes.byref(count))
            if err != 0:
                raise RuntimeError(f"softmax: cudaOccupancyMaxActiveClusters failed for a "
                                   f"cluster of {size}: cudaError {err} "
                                   f"({torch.cuda.get_device_name(index)})")
            found[size] = count.value
            if count.value > 0:
                return size
    raise RuntimeError(f"softmax: {torch.cuda.get_device_name(index)} holds no cluster of "
                       f"{MAX_CLUSTER} or {PORTABLE_CLUSTER} CTAs with {SMEM_BUDGET} bytes of "
                       f"shared memory each: {found}")


def plan_for(x, out, max_cluster: int | None = None) -> Plan:
    """The plan of softmax_2d(x, out) on x's card (``max_cluster``: a smaller
    cap than the card's, to measure another cluster size)."""
    rows, d = x.shape
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    cap = _max_cluster(index, x.dtype) if d > NARROW_MAX else MAX_CLUSTER
    if max_cluster is not None:
        cap = min(cap, max_cluster)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return plan(rows, d, x.element_size(), sm_count(x.device), aligned, cap)


def softmax_2d(x, out, max_cluster: int | None = None) -> None:
    """x, out: contiguous (rows, d) CUDA tensors of one dtype, rows, d >= 1.
    Checks are the caller's (ops.softmax). One launch on the current stream;
    raises on a refused launch or cluster."""
    rows, d = x.shape
    p = plan_for(x, out, max_cluster)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), out.data_ptr(), rows, d, _DTYPE_CODE[x.dtype],
                    _REGIME_CODE[p.regime], p.cluster, p.chunk, p.lane, p.smem,
                    int(p.load != "element"), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmax launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(x.device)}; x {tuple(x.shape)} "
                           f"{x.dtype}; plan {p._replace(chunks=len(p.chunks))})")
