"""Continuous-batching serving, lane mode (mirrors ``repro.serve``).

- ``scheduler``: request queue, slot-table lifecycle, SLA accounting and
  ``lib.cost()``-driven admission priced against the target SRU's roofline
  (host-side control plane, no torch);
- ``slots``: reading a slot back out and validating a donor against the
  slot table (the surgery itself is ``Model.insert_slot`` / ``reset_slot``);
- ``engine``: the per-step continuous-batching loop with chunked prefill.
"""

from .engine import SamplingConfig, ServeEngine
from .scheduler import (BucketPolicy, CostModelAdmission, Request, RequestMetrics,
                        Scheduler, upd_serve_defaults)
from .slots import take_slot, validate_donor

__all__ = [
    "BucketPolicy",
    "CostModelAdmission",
    "Request",
    "RequestMetrics",
    "SamplingConfig",
    "Scheduler",
    "ServeEngine",
    "take_slot",
    "upd_serve_defaults",
    "validate_donor",
]
