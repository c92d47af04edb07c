"""Paged slot memory: block-table KV pools, copy-on-write prefix sharing, a
host-spill tier and opt-in int8 pages (mirrors ``repro/serve/paging.py``).

The contiguous slot table reserves a max-length cache per lane, so
residency is bounded by worst-case length. This layer turns the cache into a
POOL of fixed-size pages plus per-request page lists
(:class:`repro_torch.serve.slots.SlotPages`), so device memory is charged for
the tokens a request has actually produced:

* prefill completion scatters the donor's paged leaves into its pages
  (``cache_page_write``); fixed-size "tail" leaves (``state_page_axes``
  ``None`` entries; the dense family has none) are snapshotted whole;
* a completed request with no free lane PARKS (it stays resident in pages)
  and ACTIVATES later into a free lane — which is what lets residency exceed
  the lane count;
* identical prompt prefixes are prefilled ONCE: full pages of the prefix
  are content-addressed in the :class:`PrefixStore` (a sha256 digest over
  everything that determines page content) and shared read-only with
  refcounts; a write into a shared page goes through copy-on-write
  (:meth:`PagedKVStore._cow`), so a sharer never mutates another request's
  prefix;
* ``int8=True`` stores pages in the absmax-int8 wire format of
  ``repro_torch.dist.compression`` (an int8 pool with a float32 scale per
  last-axis row beside it): rows quantize on every write and dequantize per
  touched page inside the paged attention primitive, or on a lane
  activation's gather. Opt-in because it changes numerics.

FUSED mode (``PagedConfig.fused``, the default) keeps each leaf's own layout
with the token axis split in place into ``(n_pages, page)`` — the
``(L, 1, KH, S, hd)`` KV leaf becomes an ``(L, 1, KH, n_pages, page, hd)``
pool — so each layer's slice is directly the ``(KH, n_pages, page, hd)``
operand of ``attention_decode_paged``: slots decode straight off the pool
through per-step block tables (a dedicated SCRATCH page absorbs table
entries past a slot's coverage), and activation restores only the tails.
``fused=False`` keeps flat ``(n_pages * page, *row)`` pools and activates a
request by gathering its pages into a lane (the bit-identical fallback).

HOST SPILL is a tier under the pool: when the allocator runs dry and no
prefix entry is evictable, the coldest parked request's exclusive pages are
copied to host memory and their device pages released; they rehydrate into
fresh pages when the request is pinned (activated) again.

The pools (and the scale pools) live on the engine's device and are written
IN PLACE, never rebound: captured steps hold their addresses. Page size is
UPD data: the ``serve:`` block on ``cache_page_read`` declares the
candidates and :func:`selected_page_size` probes the generated library for
the selected definition. Gather/scatter of the flat layout run through the
generated primitives when the pool granularity matches that definition, and
through the same ``kernels/paged/ref.py`` bodies otherwise.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.compression import dequantize_absmax_int8, quantize_absmax_int8
from repro_torch.kernels.paged import ref as _pref

from .slots import PageAllocator, PagesExhausted, SlotPages


def upd_page_defaults() -> dict:
    """The ``serve:`` block declared on the cache_page_read primitive:
    {"page_size": int, "page_sizes": (int, ...)}. A corpus without it
    raises: page geometry is corpus data."""
    from repro_torch.core import load_corpus

    prims = load_corpus().primitives
    blk = prims["cache_page_read"].extra.get("serve") if "cache_page_read" in prims \
        else None
    if not blk or "page_size" not in blk or "page_sizes" not in blk:
        raise KeyError("the UPD corpus has no cache_page_read serve: {page_size, "
                       "page_sizes} block")
    return {"page_size": int(blk["page_size"]),
            "page_sizes": tuple(int(p) for p in blk["page_sizes"])}


def selected_page_size(ops) -> int:
    """Page size of the library's SELECTED cache_page_read definition,
    probed: the definition's page size is exactly the number of rows it
    gathers per table entry."""
    out = ops.cache_page_read(torch.zeros((1024, 1)), torch.zeros((1,), dtype=torch.int32))
    return int(out.shape[0])


def prefix_key(*, arch: str, page_size: int, int8: bool, seed: int, tokens,
               prefix_rows: int = 0, embeds=None) -> str:
    """Content address of a shareable prefix (``repro/serve/paging.py:109``):
    a sha256 digest over what determines the page content — the arch and
    param seed, the page geometry and precision (int8 and full-precision
    pages never share a key), the media prefix rows, the prefix token ids,
    and the raw bytes of the request's media when it has any (an audio
    request's frames: two requests with equal tokens and other frames have
    other cross K/V, so they must never share). The reference's digest, key
    for key."""
    h = hashlib.sha256()
    h.update(repr((arch, int(page_size), bool(int8), int(seed), int(prefix_rows))).encode())
    h.update(np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes())
    if embeds is not None:
        h.update(np.ascontiguousarray(np.asarray(embeds, np.float32)).tobytes())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class PagedConfig:
    """Engine-facing switch for paged slot memory.

    ``hbm_budget_bytes`` sizes the page pool (None: room for 2x the lane
    count at worst-case length — paged strictly dominates contiguous).
    ``page_size`` None probes the selected cache_page_read definition.
    ``max_inflight_prefills`` caps concurrent chunk schedules (None: 2x
    lanes). ``fused`` decodes straight off the block table through
    ``attention_decode_paged``; ``False`` forces the activate-into-a-lane
    fallback (bit-identical to contiguous decode). ``int8`` stores pages
    quantized (absmax int8 + a float32 scale per row): about half the
    bytes of bf16 pages, so one budget holds about twice the pages; it
    changes numerics, hence opt-in."""

    hbm_budget_bytes: int | None = None
    page_size: int | None = None
    int8: bool = False
    prefix_sharing: bool = True
    max_inflight_prefills: int | None = None
    fused: bool = True


@dataclass
class PrefixEntry:
    pages: list[int]
    n_rows: int                       # cache rows the pages cover
    tail: dict | None                 # host snapshot of tail leaves at n_rows
    stamp: int                        # LRU tick


class PrefixStore:
    """Content-addressed store of shared, read-only prefix pages.

    ``publish`` retains the pages (the store holds one reference);
    ``lookup`` retains them again for the new sharer. Entries whose pages
    have no sharer left (refcount 1, held only by the store) are evictable
    LRU when the allocator runs dry."""

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        self.entries: dict[str, PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self._tick = 0

    def lookup(self, key: str) -> PrefixEntry | None:
        entry = self.entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._tick += 1
        entry.stamp = self._tick
        for p in entry.pages:
            self._alloc.retain(p)
        self.hits += 1
        return entry

    def publish(self, key: str, pages: list[int], n_rows: int,
                tail: dict | None) -> bool:
        """Retain ``pages`` under ``key``; no-op if already present (the
        engine publishes only on a miss)."""
        if key in self.entries:
            return False
        for p in pages:
            self._alloc.retain(p)
        self._tick += 1
        self.entries[key] = PrefixEntry(list(pages), n_rows, tail, self._tick)
        return True

    def evictable(self) -> list[str]:
        return [k for k, e in self.entries.items()
                if all(self._alloc.refcount(p) == 1 for p in e.pages)]

    def evictable_pages(self) -> int:
        return sum(len(self.entries[k].pages) for k in self.evictable())

    def evict_one(self) -> bool:
        """Drop the LRU entry with no active sharers. Returns False when
        nothing is evictable."""
        cands = self.evictable()
        if not cands:
            return False
        key = min(cands, key=lambda k: self.entries[k].stamp)
        for p in self.entries.pop(key).pages:
            self._alloc.release(p)
        return True


class PagedKVStore:
    """Device page pools + per-request page lists + the prefix store.

    Built from a DONOR's leaf shapes (slot axis of size 1;
    ``{leaf: (shape, dtype)}``) and the family's ``state_page_axes``. Leaves
    with a token axis get a pool (flat rows, or the fused in-place split);
    ``None`` leaves are TAIL state, stored as whole host snapshots per
    request and charged to the same page budget as a ceil(tail_bytes /
    page_bytes) reservation. ``ops`` is the generated library's primitive
    namespace (cache_page_read/write for the flat layout).

    ``int8``: every paged leaf's pool holds int8 payloads, and a float32
    scale pool of the same layout with a last axis of 1 sits beside it
    (``scale_pools``; ``{leaf}__scale`` in :meth:`device_pools`); a row costs
    its elements plus 4 bytes per last-axis row. ``device``: the card by
    default (``resolve_device``); ``"cpu"`` must be asked for, and ``"meta"``
    prices a layout without allocating it."""

    def __init__(self, donor_shapes: dict, page_axes: dict, *, page_size: int, ops,
                 hbm_budget_bytes: int | None = None, n_pages: int | None = None,
                 int8: bool = False, fused: bool = False,
                 device: torch.device | str = "cuda"):
        self.page = int(page_size)
        self.int8 = bool(int8)
        dev = torch.device(device)
        self.device = dev if dev.type == "meta" else resolve_device(dev)
        self._ops = ops
        self.paged: dict[str, tuple[int, tuple, torch.dtype]] = {}
        self.tail_leaves: dict[str, tuple[tuple, torch.dtype]] = {}
        tail_bytes = 0
        row_bytes = 0
        fp_row_bytes = 0
        for name, (shape, dtype) in donor_shapes.items():
            ax = page_axes.get(name)
            itemsize = dtype.itemsize
            if ax is None:
                self.tail_leaves[name] = (tuple(shape), dtype)
                tail_bytes += int(np.prod(shape)) * itemsize
                continue
            row_shape = tuple(int(s) for i, s in enumerate(shape) if i != ax)
            self.paged[name] = (int(ax), row_shape, dtype)
            n_elem = int(np.prod(row_shape))
            fp_row_bytes += n_elem * itemsize
            # int8: the payload plus one float32 scale per last-axis row
            row_bytes += n_elem + 4 * int(np.prod(row_shape[:-1])) if self.int8 \
                else n_elem * itemsize
        self.row_bytes = row_bytes
        self.fp_row_bytes = fp_row_bytes
        self.tail_bytes = tail_bytes
        self.page_bytes = self.page * row_bytes if row_bytes else max(tail_bytes, 1)
        if n_pages is None:
            if hbm_budget_bytes is None:
                raise ValueError("pass hbm_budget_bytes or n_pages")
            n_pages = max(int(hbm_budget_bytes) // self.page_bytes, 1)
        self.n_pages = int(n_pages)
        self.allocator = PageAllocator(self.n_pages)
        self.prefix_store = PrefixStore(self.allocator)
        self.tail_pages = -(-tail_bytes // self.page_bytes) if tail_bytes else 0
        self.fused = bool(fused) and bool(self.paged)
        # written in place only, never rebound: captured steps point at them
        self.pools: dict[str, torch.Tensor] = {}
        self.scale_pools: dict[str, torch.Tensor] = {}
        for name, (ax, row_shape, dt) in self.paged.items():
            if self.fused:
                # the leaf's own layout, token axis split in place into
                # (n_pages, page): directly the fused primitive's pool operand
                shape = row_shape[:ax] + (self.n_pages, self.page) + row_shape[ax:]
            else:
                shape = (self.n_pages * self.page,) + row_shape
            if self.int8:
                self.pools[name] = torch.zeros(shape, dtype=torch.int8, device=self.device)
                self.scale_pools[name] = torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                                    device=self.device)
            else:
                self.pools[name] = torch.zeros(shape, dtype=dt, device=self.device)
        self.requests: dict[str, SlotPages] = {}
        self.tails: dict[str, dict | None] = {}
        self._tail_res: dict[str, list[int]] = {}
        self._ops_page: int | None = None
        self.resident_peak = 0
        self.pages_used_peak = 0
        self.cow_copies = 0
        # host-spill tier: rid -> page index -> {leaf: (page, *row) host rows}
        self._spilled: dict[str, dict[int, dict[str, torch.Tensor]]] = {}
        self._pinned: set[str] = set()
        self._lru: dict[str, int] = {}          # unpin stamps (cold order)
        self._lru_tick = 0
        self.spills = 0
        self.rehydrates = 0
        # fused decode needs every table entry to be a VALID page id even
        # past a slot's coverage: one scratch page absorbs them (and the row
        # writes of inactive slots)
        self.scratch_page: int | None = None
        if self.fused:
            self.scratch_page = self.allocator.alloc()

    # -- gather/scatter -------------------------------------------------------

    def _all_pools(self):
        """(key, pool, token axis) of every pool: the payloads, and with int8
        their scale pools under ``{leaf}__scale`` (what spill, rehydrate and
        copy-on-write move together, bit for bit)."""
        for name, pool in self.pools.items():
            ax = self.paged[name][0]
            yield name, pool, ax
            if self.int8:
                yield f"{name}__scale", self.scale_pools[name], ax

    def _use_ops(self) -> bool:
        if self._ops_page is None:
            self._ops_page = selected_page_size(self._ops)
        return self._ops_page == self.page

    def _offsets(self, pages) -> torch.Tensor:
        return torch.tensor([p * self.page for p in pages], dtype=torch.int32,
                            device=self.device)

    def _page_index(self, ax: int, pids) -> tuple:
        return (slice(None),) * ax + (torch.tensor(pids, dtype=torch.long,
                                                   device=self.device),)

    def _pool_gather(self, pool, ax, pids) -> torch.Tensor:
        """(len(pids)*page, *row) rows for page ids ``pids``, either layout."""
        if self.fused:
            g = pool[self._page_index(ax, pids)].movedim((ax, ax + 1), (0, 1))
            return g.reshape((len(pids) * self.page,) + tuple(g.shape[2:]))
        if self._use_ops():
            return self._ops.cache_page_read(pool, self._offsets(pids))
        return _pref.page_read(pool, self._offsets(pids), page=self.page)

    def _pool_scatter(self, pool, ax, rows, pids) -> None:
        """Write (len(pids)*page, *row) rows into pages ``pids``, in place."""
        if self.fused:
            blocks = rows.to(pool.dtype).reshape((len(pids), self.page)
                                                 + tuple(rows.shape[1:]))
            pool[self._page_index(ax, pids)] = blocks.movedim((0, 1), (ax, ax + 1))
        elif self._use_ops():
            self._ops.cache_page_write(pool, rows, self._offsets(pids))
        else:
            _pref.page_write(pool, rows, self._offsets(pids), page=self.page)

    # -- accounting (the admission "budget" interface) ------------------------

    def pages_for_rows(self, rows: int) -> int:
        """Pages one request needs for ``rows`` committed cache rows,
        including its tail reservation — the price admission charges."""
        data = -(-int(rows) // self.page) if self.paged else 0
        return data + self.tail_pages

    def pages_free(self) -> int:
        """Pages allocatable RIGHT NOW: the free list, every prefix-store
        page no live request shares, and every cold page the spill tier can
        reclaim."""
        return self.allocator.free_pages + self.prefix_store.evictable_pages() \
            + self.spillable_pages()

    def hbm_bytes_resident(self) -> int:
        used = self.allocator.used_pages - (1 if self.scratch_page is not None else 0)
        return used * self.page_bytes

    def resident_requests(self) -> int:
        return len(self.requests)

    def contiguous_bytes_per_slot(self, max_len: int) -> int:
        """What ONE contiguous full-precision slot reserves (rows x max_len +
        the tail), for the resident-requests comparison at equal budget."""
        return max_len * self.fp_row_bytes + self.tail_bytes

    def _note_usage(self):
        self.pages_used_peak = max(self.pages_used_peak, self.allocator.used_pages)
        self.resident_peak = max(self.resident_peak, len(self.requests))

    def _alloc_page(self) -> int:
        while True:
            try:
                page = self.allocator.alloc()
                self._note_usage()
                return page
            except PagesExhausted:
                if self.prefix_store.evict_one():
                    continue
                if self._spill_one():
                    continue
                raise

    # -- request lifecycle ----------------------------------------------------

    def attach(self, rid: str, *, prompt_rows: int, share_key: str | None = None) -> int:
        """Admit ``rid``: retain shared prefix pages on a prefix-store hit,
        allocate the remaining prompt pages and the tail reservation.
        Returns the number of shared cache rows (0 on a miss). Raises
        PagesExhausted with everything rolled back if the pool cannot cover
        the request right now."""
        if rid in self.requests:
            raise ValueError(f"request {rid!r} already attached")
        sp = SlotPages()
        tail = None
        shared_rows = 0
        if share_key is not None:
            entry = self.prefix_store.lookup(share_key)
            if entry is not None:
                sp.pages = list(entry.pages)
                sp.n_shared = len(entry.pages)
                shared_rows = entry.n_rows
                tail = entry.tail
        got_tail_res: list[int] = []
        try:
            if self.paged:
                while sp.covered_rows(self.page) < prompt_rows:
                    sp.pages.append(self._alloc_page())
            for _ in range(self.tail_pages):
                got_tail_res.append(self._alloc_page())
        except PagesExhausted:
            for p in sp.pages:              # fresh pages and the lookup retains
                self.allocator.release(p)
            for p in got_tail_res:
                self.allocator.release(p)
            raise
        sp.fill = shared_rows
        self.requests[rid] = sp
        self.tails[rid] = tail
        self._tail_res[rid] = got_tail_res
        self._pinned.add(rid)      # fresh requests are hot until parked
        self._note_usage()
        return shared_rows

    def grow(self, rid: str, rows: int) -> None:
        """Extend ``rid``'s page coverage to ``rows`` committed cache rows
        (decode growth). Raises PagesExhausted — the engine preempts."""
        sp = self.requests[rid]
        if self.paged:
            while sp.covered_rows(self.page) < rows:
                sp.pages.append(self._alloc_page())
        sp.fill = max(sp.fill, int(rows))

    def free(self, rid: str) -> None:
        """Release every page reference ``rid`` holds (the prefix store
        keeps its own reference to shared pages). Spilled pages (-1) hold no
        device reference; their host copies are dropped."""
        sp = self.requests.pop(rid)
        for p in sp.pages:
            if p >= 0:
                self.allocator.release(p)
        for p in self._tail_res.pop(rid, ()):
            self.allocator.release(p)
        self.tails.pop(rid, None)
        self._spilled.pop(rid, None)
        self._pinned.discard(rid)
        self._lru.pop(rid, None)

    # -- host-spill tier ------------------------------------------------------

    def pin(self, rid: str) -> None:
        """Mark ``rid`` hot (active in a lane or on the fused decode path):
        its pages cannot spill, and any spilled pages rehydrate now."""
        self._pinned.add(rid)
        self._lru.pop(rid, None)
        self._rehydrate(rid)

    def unpin(self, rid: str) -> None:
        """Mark ``rid`` cold (parked): its exclusive data pages become spill
        candidates, coldest-parked first."""
        if rid not in self.requests:
            return
        self._pinned.discard(rid)
        self._lru_tick += 1
        self._lru[rid] = self._lru_tick

    def _spill_candidates(self, rid: str) -> list[int]:
        sp = self.requests[rid]
        return [i for i in range(sp.n_shared, len(sp.pages))
                if sp.pages[i] >= 0 and self.allocator.refcount(sp.pages[i]) == 1]

    def spillable_pages(self) -> int:
        """Device pages the spill tier could reclaim right now: unpinned
        requests' exclusive (refcount-1, unshared) data pages."""
        return sum(len(self._spill_candidates(rid))
                   for rid in self.requests if rid not in self._pinned)

    def spilled_pages(self) -> int:
        return sum(len(d) for d in self._spilled.values())

    def host_spill_bytes(self) -> int:
        return self.spilled_pages() * self.page_bytes

    def _spill_one(self) -> bool:
        """Copy the coldest unpinned request's last exclusive data page to
        host memory and release its device page. Returns False when nothing
        is spillable."""
        cold = sorted((rid for rid in self.requests
                       if rid not in self._pinned and self._spill_candidates(rid)),
                      key=lambda r: self._lru.get(r, 0))
        if not cold:
            return False
        rid = cold[0]
        sp = self.requests[rid]
        i = self._spill_candidates(rid)[-1]
        pid = sp.pages[i]
        self._spilled.setdefault(rid, {})[i] = {
            key: self._pool_gather(pool, ax, [pid]).cpu()
            for key, pool, ax in self._all_pools()}
        sp.pages[i] = -1
        self.allocator.release(pid)
        self.spills += 1
        return True

    def _rehydrate(self, rid: str) -> None:
        """Restore every spilled page of ``rid`` into fresh device pages.
        The request is pinned meanwhile so the allocation fallback cannot
        spill it back out from under itself."""
        spilled = self._spilled.get(rid)
        if not spilled:
            return
        was_pinned = rid in self._pinned
        self._pinned.add(rid)
        try:
            sp = self.requests[rid]
            for i in sorted(spilled):
                fresh = self._alloc_page()
                for key, pool, ax in self._all_pools():
                    self._pool_scatter(pool, ax, spilled[i][key].to(self.device), [fresh])
                sp.pages[i] = fresh
                self.rehydrates += 1
            del self._spilled[rid]
        finally:
            if not was_pinned:
                self._pinned.discard(rid)

    # -- data movement --------------------------------------------------------

    def _cow(self, sp: SlotPages, p0: int, p1: int) -> None:
        """Copy-on-write: any page in [p0, p1) shared with someone else
        (refcount > 1) is copied into a fresh exclusive page before the
        caller writes."""
        for i in range(p0, min(p1, len(sp.pages))):
            pid = sp.pages[i]
            if self.allocator.refcount(pid) <= 1:
                continue
            fresh = self._alloc_page()
            for _, pool, ax in self._all_pools():
                self._pool_scatter(pool, ax, self._pool_gather(pool, ax, [pid]), [fresh])
            self.allocator.release(pid)
            sp.pages[i] = fresh
            sp.n_shared = min(sp.n_shared, i)
            self.cow_copies += 1

    def write_rows(self, rid: str, row0: int, row1: int, rows_by_leaf: dict) -> None:
        """Write cache rows [row0, row1) of every paged leaf (rows_by_leaf:
        {leaf: (row1-row0, *row) tensors}) through copy-on-write. row0 must
        be page-aligned; the final partial page is zero-padded (rows past
        the request's fill, never read)."""
        if not self.paged or row1 <= row0:
            return
        if row0 % self.page:
            raise ValueError(f"write start {row0} not page-aligned ({self.page})")
        sp = self.requests[rid]
        p0, p1 = row0 // self.page, -(-row1 // self.page)
        if p1 > len(sp.pages):
            raise ValueError(f"write [{row0},{row1}) beyond {rid!r}'s "
                             f"{len(sp.pages)} pages")
        self._cow(sp, p0, p1)
        pids = sp.pages[p0:p1]
        need = (p1 - p0) * self.page
        for name, pool in self.pools.items():
            ax = self.paged[name][0]
            rows = rows_by_leaf[name]
            if rows.shape[0] < need:
                pad = rows.new_zeros((need - rows.shape[0],) + tuple(rows.shape[1:]))
                rows = torch.cat([rows, pad])
            if self.int8:
                q, scale = quantize_absmax_int8(rows)
                self._pool_scatter(pool, ax, q, pids)
                self._pool_scatter(self.scale_pools[name], ax, scale, pids)
            else:
                self._pool_scatter(pool, ax, rows, pids)

    def snapshot_tail(self, donor: dict) -> dict:
        """Host copies of the tail leaves."""
        return {name: donor[name].cpu().clone() for name in self.tail_leaves}

    def store_donor(self, rid: str, donor: dict, *, fill: int,
                    tail: dict | None = None) -> None:
        """Scatter a completed prefill's paged rows [shared_end, fill) into
        the request's pages and stash its tail snapshot. Shared prefix rows
        are already resident — the prefill-once contract."""
        sp = self.requests[rid]
        self.grow(rid, fill)
        row0 = sp.n_shared * self.page
        if self.paged and fill > row0:
            slabs = {}
            for name, (ax, _, _) in self.paged.items():
                rows = donor[name].movedim(ax, 0)
                slabs[name] = rows[row0:min(fill, rows.shape[0])]
            self.write_rows(rid, row0, fill, slabs)
        sp.fill = int(fill)
        if tail is not None:
            self.tails[rid] = tail
        elif self.tail_leaves:
            self.tails[rid] = self.snapshot_tail(donor)

    def load_donor(self, rid: str, donor: dict) -> dict:
        """Gather the request's pages (and tail snapshot) back into a donor
        of ``donor``'s shapes, rows past the fill zeroed — the lane fallback's
        activation path. Full-precision pages round-trip bit-exactly; int8
        pages dequantize to the leaf's dtype. A template without the paged
        leaves (the fused engine restoring tails only) skips the gather."""
        self._rehydrate(rid)
        sp = self.requests[rid]
        out = dict(donor)
        want = [n for n in self.paged if n in out]
        if want and sp.pages and sp.fill:
            for name in want:
                ax, _, dt = self.paged[name]
                rows = self._pool_gather(self.pools[name], ax, sp.pages)
                if self.int8:
                    rows = dequantize_absmax_int8(
                        rows, self._pool_gather(self.scale_pools[name], ax, sp.pages),
                        dtype=dt)
                n_rows = out[name].shape[ax]
                rows = rows[:min(sp.fill, n_rows)]
                full = rows.new_zeros((n_rows,) + tuple(rows.shape[1:]))
                full[:rows.shape[0]] = rows
                out[name] = full.movedim(0, ax)
        tail = self.tails.get(rid)
        if tail:
            for name, arr in tail.items():
                # a copy: the engine updates donors in place, and the snapshot
                # (a prefix entry's, shared by every hit) must not follow it
                out[name] = arr.to(self.device, self.tail_leaves[name][1], copy=True)
        return out

    # -- fused-decode interface -----------------------------------------------

    def device_pools(self) -> dict:
        """The pools the fused steps read and write in place, keyed by leaf
        name; int8 scale pools ride along as ``{leaf}__scale``. The tensors
        are the store's own, for its whole life."""
        out = dict(self.pools)
        out.update({f"{n}__scale": t for n, t in self.scale_pools.items()})
        return out

    def table_row(self, rid: str, width: int) -> np.ndarray:
        """``rid``'s block-table row, padded to ``width`` entries with the
        scratch page (every entry must be a valid page id). The request must
        be pinned/rehydrated: spilled pages have no device identity."""
        pages = self.requests[rid].pages[:width]
        if any(p < 0 for p in pages):
            raise ValueError(f"request {rid!r} has spilled pages — pin() before "
                             "building its table row")
        row = np.full((width,), self.scratch_page, np.int32)
        row[:len(pages)] = pages
        return row

    def publish_prefix(self, rid: str, key: str, *, n_rows: int,
                       tail: dict | None) -> bool:
        """Publish ``rid``'s leading full pages covering [0, n_rows) under
        ``key``. No-op when the key is already present."""
        sp = self.requests[rid]
        if self.paged:
            if n_rows % self.page:
                raise ValueError(f"publish boundary {n_rows} not page-aligned "
                                 f"({self.page})")
            pages = sp.pages[:n_rows // self.page]
        else:
            pages = []
        return self.prefix_store.publish(key, pages, n_rows, tail)
