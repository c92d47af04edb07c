"""Fault-tolerant checkpoints (mirrors ``repro/ckpt/checkpoint.py``), in the
reference's format, so each reads the other's:

    <dir>/step_<N>/
        manifest.json   (step, n_leaves, shapes, dtypes, integrity checksums,
                         extra: the data-pipeline state)
        leaf_<i>.npy    (one file per leaf, on the host)

Leaf ``i`` is the i-th leaf in JAX's flatten order: dict keys sorted at
every level (``opt/count``, ``opt/m/...``, ``opt/v/...``, ``params/...``;
an int8 moment's ``q`` before its ``scale``), whatever order the port's
dicts were built in. Dtype strings are the reference's (``"bfloat16"``,
``"float32"``, ``"int8"``, ``"int32"``); a bfloat16 leaf is stored as its
uint16 view, which the reference restores through the manifest's dtype. A
checksum is the first 16 hex digits of the sha256 of the leaf's bytes. A
host int leaf (the optimizer's step count) is saved as a 0-d int32 array
and restored as an int. The manifest's ``structure`` field
is the list of leaf paths: the reference writes ``str(treedef)`` there,
which the port cannot produce, and neither side's restore reads it.

Atomicity: written into ``step_<N>.tmp`` and renamed, so a crash mid-write
never leaves a torn checkpoint (restore takes the highest committed step).
Async: the device-to-host copy happens on the caller's thread; the writer
thread touches only numpy (checksums, files, the rename, the GC of all but
the ``keep`` newest). ``wait()`` joins it and raises what it raised.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

# numpy's .npy cannot hold bfloat16: it is stored as its uint16 view, which
# torch reaches through int16 (the reference views it through ml_dtypes)
BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten(tree, leaves: list):
    """``leaves`` (in :func:`_flatten` order) put back into ``tree``'s
    structure, its own key order kept."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    return build(tree)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(storable array, logical dtype name) of a leaf, copied to the host."""
    if isinstance(leaf, bool) or not isinstance(leaf, (int, torch.Tensor)):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: want a tensor "
                        f"or an int")
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             async_: bool = True) -> None:
        self.wait()
        items = _flatten(tree)
        host = [_to_host(leaf) for _, leaf in items]      # on the caller's thread

        def write():
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "process_count": 1,
                "structure": [path for path, _ in items],
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [name for _, name in host],
                "checksums": [_checksum(a) for a, _ in host],
                "extra": extra or {},
            }
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (arr, _) in enumerate(host):
                np.save(tmp / f"leaf_{i}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():                          # re-save of same step
                shutil.rmtree(final)
            os.replace(tmp, final)                      # atomic commit
            self._gc()

        if not async_:
            write()
            return

        def run():
            try:
                write()
            except BaseException as exc:              # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.completed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def completed_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def restore(self, step: int, target_tree: Any) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``: each leaf takes its
        target's dtype and device (an int target gives an int). Raises on a
        leaf count, checksum or shape that does not match; skips nothing."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        items = _flatten(target_tree)
        if manifest["n_leaves"] != len(items):
            raise ValueError(f"checkpoint step {step} has {manifest['n_leaves']} leaves, "
                             f"the target tree {len(items)}: tree structure changed")
        out = []
        for i, (path, ref) in enumerate(items):
            arr = np.load(d / f"leaf_{i}.npy")
            if _checksum(arr) != manifest["checksums"][i]:
                raise IOError(f"checksum mismatch on leaf {i} ({path}): corrupt checkpoint")
            want = () if isinstance(ref, int) else tuple(ref.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i} ({path}): shape {tuple(arr.shape)} in the "
                                 f"checkpoint, {want} in the target")
            t = _from_storable(arr, manifest["dtypes"][i])
            out.append(int(t) if isinstance(ref, int)
                       else t.to(device=ref.device, dtype=ref.dtype))
        return _unflatten(target_tree, out), manifest["extra"]

    def restore_latest(self, target_tree: Any) -> tuple[int, Any, dict] | None:
        steps = self.completed_steps()
        if not steps:
            return None
        tree, extra = self.restore(steps[-1], target_tree)
        return steps[-1], tree, extra
