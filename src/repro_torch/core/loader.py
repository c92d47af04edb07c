"""UPD loading (paper §3.2 ⑤ "Input Description").

The paper uses YAML with *"a single YAML document, enclosed by three dashes at
the beginning and three dots at the end, for every primitive"* — i.e.
multi-document streams per group file.  Targets are one document per file.
PyYAML is on both the host and the machine with the card, so the port reads
the YAML itself, exactly as the JAX package does.
"""

from __future__ import annotations

from pathlib import Path

import yaml

DEFAULT_UPD_ROOT = Path(__file__).resolve().parent.parent / "tsl_data"


def _upd_roots(extra: tuple[str, ...] = ()) -> list[Path]:
    return [DEFAULT_UPD_ROOT, *(Path(p) for p in extra)]


def load_raw_targets(extra_paths: tuple[str, ...] = ()) -> list[dict]:
    docs: list[dict] = []
    for root in _upd_roots(extra_paths):
        tdir = root / "targets"
        if not tdir.is_dir():
            continue
        for f in sorted(tdir.glob("*.yaml")):
            for doc in yaml.safe_load_all(f.read_text()):
                if doc is None:
                    continue
                doc.setdefault("__source__", str(f))
                docs.append(doc)
    return docs


def load_raw_primitives(extra_paths: tuple[str, ...] = ()) -> list[dict]:
    docs: list[dict] = []
    for root in _upd_roots(extra_paths):
        pdir = root / "primitives"
        if not pdir.is_dir():
            continue
        for f in sorted(pdir.glob("*.yaml")):
            group_default = f.stem
            for doc in yaml.safe_load_all(f.read_text()):
                if doc is None:
                    continue
                doc.setdefault("group", group_default)
                doc.setdefault("__source__", str(f))
                docs.append(doc)
    return docs


def upd_fingerprint(extra_paths: tuple[str, ...] = ()) -> str:
    """Content hash over all UPD + template files — cache key for generation."""
    import hashlib

    h = hashlib.sha256()
    files: list[Path] = []
    for root in _upd_roots(extra_paths):
        if root.is_dir():
            files += sorted(root.rglob("*.yaml"))
    tmpl = Path(__file__).resolve().parent / "templates"
    if tmpl.is_dir():
        files += sorted(tmpl.rglob("*.j2"))
    # generator source itself participates: a generator change must invalidate
    core = Path(__file__).resolve().parent
    files += sorted(core.glob("*.py"))
    for f in files:
        h.update(str(f).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]
