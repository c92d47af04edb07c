"""Wrapper the ``h100`` attention_decode_paged definition calls (mirrors
``repro/kernels/paged/ops.py``): a CUDA tensor launches the CUDA C++
block-table kernel (or raises on what it does not take), a CPU tensor takes
the plain version. ``paged_attention.launches`` counts kernel launches.

The page size is not a parameter: it is read off the pool's page axis. The
key block is clamped to divide the page (``block_k`` candidates smaller than
the page tile it; anything else degrades to one block per page), and the
kernel walks it in tiles of at most 64 rows that divide the block. GQA is
folded: the group * SQ query rows of one KV head ride in one block."""

from __future__ import annotations

import math

import torch

from ..common import check_cuda_tensor
from . import kernel, ref

_DTYPES = (torch.float32, torch.bfloat16)


def paged_attention(q, k_pool, v_pool, tables, kv_len, *, k_scale=None, v_scale=None,
                    scale=None, block_k: int = 64):
    """q (B,H,SQ,D); k_pool/v_pool (KH, n_pages, page, D); tables (B,P) int32
    page ids; kv_len (B,) int32 (a scalar broadcasts; a device tensor stays
    on the device). Returns (B,H,SQ,D) in q's dtype."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 page pools (k_scale/v_scale) are not ported "
                                  "yet: see ROADMAP.md, queue 1, item 6")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, tables, kv_len, scale=scale)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        check_cuda_tensor(t, f"paged_attention {name}", _DTYPES)
    check_cuda_tensor(tables, "paged_attention tables", (torch.int32,))
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape or tables.ndim != 2:
        raise ValueError(f"paged_attention: want q (B,H,SQ,D), k_pool = v_pool "
                         f"(KH,n_pages,page,D), tables (B,P); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, "
                         f"{tuple(tables.shape)}")
    b, h, sq, d = q.shape
    kh, _, page, pd = k_pool.shape
    if pd != d or kh == 0 or h % kh or tables.shape[0] != b or tables.shape[1] == 0:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} / tables "
                         f"{tuple(tables.shape)} do not match q {tuple(q.shape)} "
                         f"(head dim, H % KH, batch)")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {kernel.HEAD_DIMS}")
    if (h // kh) * sq > kernel.MAX_ROWS:
        raise ValueError(f"paged_attention: group*SQ = {(h // kh) * sq} query rows per "
                         f"KV head > {kernel.MAX_ROWS}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype \
            or len({t.device for t in (q, k_pool, v_pool, tables)}) != 1:
        raise ValueError("paged_attention: q and the pools must share dtype, and all "
                         "operands one device")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte aligned")
    kvl = torch.as_tensor(kv_len, device=q.device)
    if kvl.dtype.is_floating_point or kvl.numel() not in (1, b):
        raise ValueError(f"paged_attention: kv_len must be an int or (B,) ints, "
                         f"got {kvl.dtype} {tuple(kvl.shape)}")
    kvl = kvl.to(torch.int32).reshape(-1).expand(b).contiguous()
    bk = block_k if (block_k <= page and page % block_k == 0) else page
    tile = math.gcd(bk, kernel.tile_rows(q.dtype, d))
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if q.numel():
        kernel.paged_attention_4d(q, k_pool, v_pool, tables, kvl, out, tile=tile,
                                  scale=scale)
        paged_attention.launches += 1
    return out


paged_attention.launches = 0

__all__ = ["paged_attention", "ref"]
