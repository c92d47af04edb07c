"""State surgery companions for continuous batching and the paged-memory
bookkeeping (mirrors ``repro/serve/slots.py``).

The dense family carries its decode state as a dict of tensors with the
request (slot) axis at a per-leaf position that ``Model.state_batch_axes``
declares; ``Model.insert_slot`` / ``reset_slot`` do the surgery. This module
reads a slot back out (``take_slot``), validates a donor against the slot
table on the host (``validate_donor``) before it is grafted, and checks that
a speculative verify span fits the table's rows (``assert_span_fits``).

The paged building blocks are pure host bookkeeping: :class:`PageAllocator`,
a refcounted free list over fixed-size cache pages (the unit the paged store
accounts device memory in), and :class:`SlotPages`, one request's page list
and fill. The device pools and the gather/scatter through the
``cache_page_read`` / ``cache_page_write`` primitives live in
``serve/paging.py``."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class PagesExhausted(RuntimeError):
    """No free page: the caller must evict/preempt or defer admission."""


class PageAllocator:
    """Refcounted free-list allocator over ``n_pages`` fixed-size pages.

    Pages are ids 0..n_pages-1. ``alloc`` hands out a page at refcount 1;
    ``retain`` adds a sharer (copy-on-write prefix sharing); ``release``
    drops one reference and returns the page to the free list at zero.
    Double-free and retain-after-free raise instead of corrupting the pool."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._refs = [0] * self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self) -> int:
        if not self._free:
            raise PagesExhausted(f"all {self.n_pages} pages in use")
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _check(self, page: int) -> None:
        if not 0 <= page < self.n_pages:
            raise ValueError(f"page {page} outside pool of {self.n_pages}")

    def retain(self, page: int) -> None:
        self._check(page)
        if self._refs[page] <= 0:
            raise ValueError(f"retain of free page {page}")
        self._refs[page] += 1

    def release(self, page: int) -> None:
        self._check(page)
        if self._refs[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)


@dataclass
class SlotPages:
    """One request's page list: ``pages[i]`` covers cache rows
    [i*page_size, (i+1)*page_size). ``n_shared`` leading pages are prefix-
    store pages held by reference (read-only until copy-on-write); a spilled
    page is marked -1."""

    pages: list[int] = field(default_factory=list)
    n_shared: int = 0
    fill: int = 0                   # real cache rows committed so far

    def covered_rows(self, page_size: int) -> int:
        return len(self.pages) * page_size


def take_slot(state: dict, axes: dict, slot: int) -> dict:
    """Slot ``slot`` as a single-request state (slot axis kept, size 1 —
    what ``Model.insert_slot`` expects as a donor). Views, not copies."""
    return {name: leaf.narrow(axes[name], int(slot), 1)
            for name, leaf in state.items()}


def assert_span_fits(pos, span: int, state_len: int) -> None:
    """Raise RuntimeError if any slot's span write [pos, pos+span) would
    overrun the state's row capacity. The engine sizes the slot table with
    ``k_max`` headroom rows past max_len so this never fires; the guard
    states the broken invariant before any row is written (``cache_update``
    would raise too, later and with a less telling message)."""
    pos = np.asarray(pos)
    hi = int(pos.max()) + int(span) if pos.size else 0
    if hi > state_len:
        raise RuntimeError(f"span write [{int(pos.max())}, {hi}) overruns the "
                           f"state's {state_len} rows")


def validate_donor(state: dict, donor: dict, axes: dict) -> None:
    """Raise ValueError unless ``donor`` is shape-compatible with one slot of
    ``state``: the same leaves, identical shapes except the slot axis, which
    must be 1 (e.g. a prefill that padded its cache to another max_len)."""
    if set(donor) != set(state):
        raise ValueError(f"donor leaves {sorted(donor)} do not match the "
                         f"batched state's {sorted(state)}")
    for name, leaf in state.items():
        want = list(leaf.shape)
        want[axes[name]] = 1
        if list(donor[name].shape) != want:
            raise ValueError(
                f"donor leaf {name!r} {tuple(donor[name].shape)} incompatible "
                f"with batched leaf {tuple(leaf.shape)} (slot axis "
                f"{axes[name]}; expected {tuple(want)})")
        if donor[name].dtype != leaf.dtype or donor[name].device != leaf.device:
            raise ValueError(f"donor leaf {name!r} is {donor[name].dtype} on "
                             f"{donor[name].device}, the slot table "
                             f"{leaf.dtype} on {leaf.device}")
