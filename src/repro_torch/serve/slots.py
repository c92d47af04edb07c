"""State surgery companions for continuous batching (mirrors the lane-mode
half of ``repro/serve/slots.py``).

The dense family carries its decode state as a dict of tensors with the
request (slot) axis at a per-leaf position that ``Model.state_batch_axes``
declares; ``Model.insert_slot`` / ``reset_slot`` do the surgery. This module
reads a slot back out (``take_slot``) and validates a donor against the slot
table on the host (``validate_donor``) before it is grafted. The paged-memory
primitives of the reference wait for the paged slice of the port."""

from __future__ import annotations


def take_slot(state: dict, axes: dict, slot: int) -> dict:
    """Slot ``slot`` as a single-request state (slot axis kept, size 1 —
    what ``Model.insert_slot`` expects as a donor). Views, not copies."""
    return {name: leaf.narrow(axes[name], int(slot), 1)
            for name, leaf in state.items()}


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
