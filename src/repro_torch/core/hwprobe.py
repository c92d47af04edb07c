"""Hardware probe (paper Fig 7a: ``cpuinfo.get_cpu_info()['flags']`` feeding
``--targets``). Here: map the torch device an entry point runs on to an SRU
name. The generator can also be "tricked into assuming specific hardware"
(paper §4.1) by naming a target explicitly — that is how the ``h100``
library is cross-generated on a host without a card.

A Hopper card (capability 9.0) maps to ``h100``, the host to ``torch_cpu``;
any other CUDA device raises rather than being treated as a CPU. Flag sets
are not duplicated here: the SRU's own ``lscpu_flags`` in the UPD are the
single source of truth."""

from __future__ import annotations

import torch

from repro_torch.device import target_for


def live_target(device: torch.device | str = "cuda") -> str:
    return target_for(device)
