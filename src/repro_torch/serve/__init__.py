"""Continuous-batching serving, lane mode and paged (mirrors ``repro.serve``).

- ``scheduler``: request queue, slot-table lifecycle, SLA accounting and
  ``lib.cost()``-driven admission priced against the target SRU's roofline,
  plus page-count admission (host-side control plane, no torch);
- ``slots``: reading a slot back out, validating a donor against the slot
  table (the surgery itself is ``Model.insert_slot`` / ``reset_slot``), and
  the refcounted page allocator;
- ``paging``: block-table page pools, copy-on-write prefix sharing and the
  host-spill tier;
- ``spec``: speculative decoding — the n-gram and draft-model drafters, the
  longest-accepted-prefix rule and the cost-priced per-slot depth
  (``attention_verify``'s serve block and cost term);
- ``graphs``: the compiled steps — decode, verify and prefill chunk captured
  in CUDA graphs on the card (the reference's jitted steps and its
  ``jit_cache``), and ``disable_graphs()``, the one way to run them eagerly;
- ``engine``: the per-step continuous-batching loop with chunked prefill,
  lane-mode or paged (fused decode off the pools, or the lane fallback), and
  its speculative decode-or-verify step.
"""

from .engine import SamplingConfig, ServeEngine
from .graphs import StepGraphs, disable_graphs
from .paging import (PagedConfig, PagedKVStore, PrefixEntry, PrefixStore, prefix_key,
                     selected_page_size, upd_page_defaults)
from .scheduler import (BucketPolicy, CostModelAdmission, PagedAdmission, Request,
                        RequestMetrics, Scheduler, upd_serve_defaults)
from .slots import (PageAllocator, PagesExhausted, SlotPages, assert_span_fits, take_slot,
                    validate_donor)
from .spec import (DraftModelDrafter, NGramDrafter, SpeculationConfig,
                   SpeculationPolicy, accept_span, build_drafter, upd_verify_defaults)

__all__ = [
    "BucketPolicy",
    "CostModelAdmission",
    "DraftModelDrafter",
    "NGramDrafter",
    "PageAllocator",
    "PagedAdmission",
    "PagedConfig",
    "PagedKVStore",
    "PagesExhausted",
    "PrefixEntry",
    "PrefixStore",
    "Request",
    "RequestMetrics",
    "SamplingConfig",
    "Scheduler",
    "ServeEngine",
    "SlotPages",
    "SpeculationConfig",
    "SpeculationPolicy",
    "StepGraphs",
    "accept_span",
    "assert_span_fits",
    "build_drafter",
    "disable_graphs",
    "prefix_key",
    "selected_page_size",
    "take_slot",
    "upd_page_defaults",
    "upd_serve_defaults",
    "upd_verify_defaults",
    "validate_donor",
]
