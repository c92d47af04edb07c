"""Paged cache gather/scatter and block-table attention in plain PyTorch
(mirrors ``repro/kernels/paged/ref.py``): the ``cache_page_read`` /
``cache_page_write`` bodies on both targets, the ``torch_cpu``
``attention_decode_paged`` definition, and what the Hopper kernel
(``kernels/paged/csrc``) is held against on the card.

The flat pool is a token-row store ``(capacity_rows, *row_shape)``; a page is
``page`` consecutive rows and the table passed to ``page_read`` /
``page_write`` holds each page's STARTING ROW offset, so one pool serves any
page-size candidate. ``paged_attention_ref`` instead takes the fused layout
``(KH, n_pages, page, D)`` and a table of PAGE IDS.

Unlike the reference, the writes update the pool IN PLACE (and return it),
as the port's ``cache_update`` does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _rows(table: torch.Tensor, page: int) -> torch.Tensor:
    table = torch.as_tensor(table).long()
    return (table[:, None] + torch.arange(page, device=table.device)).reshape(-1)


def page_read(pool, table, *, page: int):
    """Gather ``page`` consecutive rows per table entry: pool (cap, *row),
    table (N,) start-row offsets -> (N * page, *row), in table order."""
    return pool[_rows(table, page).to(pool.device)]


def page_read_blocked(pool, table, *, page: int):
    """Same as :func:`page_read`, one contiguous slice per page (the
    large-page schedule)."""
    starts = torch.as_tensor(table).tolist()
    return torch.cat([pool[s:s + page] for s in starts])


def page_write(pool, rows, table, *, page: int):
    """Scatter ``page`` consecutive rows per table entry into ``pool`` in
    place; rows (N * page, *row) in table order. Returns the pool."""
    pool[_rows(table, page).to(pool.device)] = rows.to(pool.dtype)
    return pool


def page_write_blocked(pool, rows, table, *, page: int):
    """Same as :func:`page_write`, one contiguous slice copy per page."""
    starts = torch.as_tensor(table).tolist()
    blocks = rows.to(pool.dtype).reshape((len(starts), page) + tuple(pool.shape[1:]))
    for s, blk in zip(starts, blocks):
        pool[s:s + page] = blk
    return pool


def paged_attention_ref(q, k_pool, v_pool, tables, kv_len, *, k_scale=None,
                        v_scale=None, scale=None, pages_per_step: int = 1):
    """Gather-free paged attention: decode/verify straight off the page pool.

    q (B, H, SQ, D); k_pool/v_pool (KH, n_pages, page, D), the whole pool;
    tables (B, P) int32 page ids; kv_len (B,) rows written per sequence
    (scalars broadcast). Span row r sits at absolute position
    kv_len - SQ + r and sees keys <= that position; a row that sees no key
    returns exactly 0. Every table entry is fetched, so entries past a
    sequence's coverage must be valid page ids (a scratch page).

    ``pages_per_step`` is the key-block knob: each step of the loop fetches
    that many table entries and runs one online-softmax update; the table is
    padded to a multiple with each sequence's first entry (those positions
    lie past every query row and mask out).

    int8 pools pass per-row ``k_scale`` / ``v_scale`` pools of shape
    (KH, n_pages, page, 1), float32: each touched page is dequantized in
    float32 inside the loop, never at a park or activate boundary. The loop
    reads no device value on the host, so it can be captured in a CUDA
    graph."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention_ref: pass both k_scale and v_scale, or neither")
    b, h, sq, d = q.shape
    kh, _, page, _ = k_pool.shape
    group = h // kh
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    r = group * sq
    dev = q.device
    # heads are KV-head-major (h = kh * group + g), as in the flash kernels
    qf = q.float().reshape(b, kh, r, d)
    kvl = torch.as_tensor(kv_len, device=dev).long().reshape(-1).expand(b)
    tables = torch.as_tensor(tables, device=dev).long()
    qi = kvl[:, None] - sq + (torch.arange(r, device=dev) % sq)[None, :]   # (B, R)
    n_p = tables.shape[1]
    g = max(int(pages_per_step), 1)
    n_steps = -(-n_p // g)
    if n_steps * g != n_p:
        tables = torch.cat([tables, tables[:, :1].expand(b, n_steps * g - n_p)], dim=1)
    grouped = tables.reshape(b, n_steps, g)
    width = g * page
    m = torch.full((b, kh, r), NEG_INF, device=dev)
    l = torch.zeros((b, kh, r), device=dev)
    acc = torch.zeros((b, kh, r, d), device=dev)
    for p in range(n_steps):
        pid = grouped[:, p]                                       # (B, G)
        k, v = k_pool[:, pid].float(), v_pool[:, pid].float()     # (KH, B, G, page, D)
        if k_scale is not None:
            k = k * k_scale[:, pid]
            v = v * v_scale[:, pid]
        k = k.movedim(1, 0).reshape(b, kh, width, d)
        v = v.movedim(1, 0).reshape(b, kh, width, d)
        s = torch.einsum("bkrd,bkcd->bkrc", qf, k) * sc
        kpos = p * width + torch.arange(width, device=dev)        # logical positions
        valid = (kpos[None, None, :] <= qi[:, :, None])[:, None]  # (B, 1, R, width)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkrc,bkcd->bkrd", pr, v)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(b, h, sq, d).to(q.dtype)
