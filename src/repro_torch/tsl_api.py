"""Framework-facing TSL access point (mirrors ``repro.tsl_api``).

Every higher layer (nn/, serve/) calls vector primitives ONLY through the
library this module hands out, so switching between the Hopper kernels and
their plain versions is regenerating the library for another target — the
paper's portability claim, upheld structurally.

``lib(device)`` resolves the target from the device the caller names (a
Hopper card -> ``h100``, the host -> ``torch_cpu``); an explicit ``target=``
or the ``REPRO_TORCH_TSL_TARGET`` environment variable overrides it, as
``REPRO_TSL_TARGET`` does in the reference. The library is generated on
first use (artifact-cache hit afterwards) and imported once per process.
"""

from __future__ import annotations

import os
from types import ModuleType

import torch

from repro_torch.core import load_library
from repro_torch.core.hwprobe import live_target


def target_name(device: torch.device | str = "cuda",
                target: str | None = None) -> str:
    """The SRU a library for ``device`` is generated for."""
    return (target or os.environ.get("REPRO_TORCH_TSL_TARGET")
            or live_target(device))


def lib(device: torch.device | str = "cuda", *, target: str | None = None,
        force: bool = False) -> ModuleType:
    """The generated library (``.ops``, ``.cost``, ``.TARGET``) for ``device``."""
    return load_library(target_name(device, target), force=force)


def ops(device: torch.device | str = "cuda", *,
        target: str | None = None) -> ModuleType:
    """The flat primitive namespace of :func:`lib`."""
    return lib(device, target=target).ops


def cost(primitive: str, term: str, *, device: torch.device | str = "cuda",
         target: str | None = None, **shapes) -> float:
    return lib(device, target=target).cost(primitive, term, **shapes)
