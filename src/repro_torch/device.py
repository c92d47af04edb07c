"""Device resolution: which torch device an entry point runs on, and which
UPD target (SRU) the generator specialises the library for on it.

``cuda`` is the default everywhere and is strict: no card, or a card that is
not Hopper (compute capability 9.0), raises instead of quietly running
somewhere else. ``cpu`` must be asked for by name (the tests do)."""

from __future__ import annotations

import torch

HOPPER_CAPABILITY = (9, 0)


def is_hopper(device: torch.device | str | None = None) -> bool:
    """True iff ``device`` (default: the current CUDA device) is an sm_90 card."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == HOPPER_CAPABILITY


def resolve_device(name: torch.device | str = "cuda") -> torch.device:
    """Validate and return the device an entry point was asked to run on."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device "
            "(pass device='cpu' / --device cpu to run on the host)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the port's kernels are built for sm_90a (Hopper) only")
    return dev


def target_for(device: torch.device | str) -> str:
    """UPD target (SRU name) for a resolved device: ``h100`` on a Hopper card,
    ``torch_cpu`` on the host. Any other device raises."""
    dev = resolve_device(device)
    return "h100" if dev.type == "cuda" else "torch_cpu"
