"""Content-addressed artifact store for generated libraries.

Every generated package is addressed by one :class:`CacheKey`:

    (UPD fingerprint, target, probed hardware flags, generator version,
     variant digest of the generation knobs)

so editing any UPD document/template/generator source, plugging the library
into different hardware, or bumping :data:`GENERATOR_VERSION` each force a
regeneration.

Layout under the cache root (default ``build/tsl_torch/``)::

    pkg/<package>_<target>_<digest>/   generated library packages

The store always publishes by rename: a package is written into a private
staging directory next to ``pkg/`` and moved into place with ONE atomic
``os.rename``, so a process that imports the package (another test worker
generating the same key at the same moment) sees either nothing or a
complete, stamped package — never a half-written file. When two writers
race, the first rename wins and the loser adopts its package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

# Bump to retire every previously generated artifact.
GENERATOR_VERSION = "torch-1.0.0"


@dataclass(frozen=True)
class CacheKey:
    """The content address of one generation run."""

    fingerprint: str                     # UPD + template + generator-source hash
    target: str                          # SRU name
    hardware_flags: tuple[str, ...]      # probed/overridden flags, sorted
    generator_version: str               # GENERATOR_VERSION at generation time
    variant: str = ""                    # digest of generation knobs

    def digest(self) -> str:
        h = hashlib.sha256()
        for part in (self.fingerprint, self.target, ",".join(self.hardware_flags),
                     self.generator_version, self.variant):
            h.update(part.encode())
            h.update(b"\0")
        return h.hexdigest()[:16]

    def as_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "target": self.target,
            "hardware_flags": list(self.hardware_flags),
            "generator_version": self.generator_version,
            "variant": self.variant,
            "digest": self.digest(),
        }


def variant_digest(config) -> str:
    """Digest of the generation knobs that change the package *content*
    beyond (corpus, target, hardware)."""
    h = hashlib.sha256(repr((
        sorted(config.only) if config.only else None, config.package_name,
        config.emit_tests,
    )).encode())
    return h.hexdigest()[:8]


class ArtifactCache:
    """Filesystem-backed store; one instance per cache root."""

    def __init__(self, root: Path | str):
        self.root = Path(root)

    @property
    def package_root(self) -> Path:
        """Importable package directory (this path goes on ``sys.path``)."""
        return self.root / "pkg"

    def package_name(self, base: str, key: CacheKey) -> str:
        return f"{base}_{key.target}_{key.digest()[:10]}"

    def package_dir(self, name: str) -> Path:
        return self.package_root / name

    def lookup(self, name: str) -> Path | None:
        """Committed package dir for ``name``, or None (a package without
        its ``_manifest.json`` stamp is not committed)."""
        d = self.package_dir(name)
        return d if (d / "_manifest.json").exists() else None

    def commit(self, name: str, key: CacheKey, files: Iterable) -> Path:
        """Stage the generated file set, stamp it, and publish it as package
        ``name`` with one atomic rename (see the module docstring)."""
        pkg_dir = self.package_dir(name)
        self.package_root.mkdir(parents=True, exist_ok=True)
        stage = Path(tempfile.mkdtemp(prefix=f".{name}.stage.",
                                      dir=self.package_root))
        try:
            for f in files:
                out = stage / f.relpath
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(f.content)
            (stage / "_cache_key.json").write_text(
                json.dumps(key.as_dict(), indent=1))
            if not (stage / "_manifest.json").exists():
                raise ValueError(f"{name}: the file set holds no _manifest.json "
                                 f"(the commit stamp)")
            try:
                os.rename(stage, pkg_dir)
            except OSError:
                # a concurrent writer published first: adopt its package
                if self.lookup(name) is None:
                    raise
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        return pkg_dir

    # -- maintenance (``python -m repro_torch.core cache ...``) ---------------

    def packages(self) -> list[Path]:
        """Committed package directories under the root."""
        if not self.package_root.is_dir():
            return []
        return sorted(d for d in self.package_root.iterdir()
                      if not d.name.startswith(".") and self.lookup(d.name) is not None)

    def stats(self) -> dict:
        pkgs = self.packages()
        size = sum(f.stat().st_size for d in pkgs for f in d.rglob("*") if f.is_file())
        return {"root": str(self.root), "packages": len(pkgs), "bytes": size}

    def clear(self) -> int:
        """Remove every committed package; returns how many."""
        pkgs = self.packages()
        for d in pkgs:
            shutil.rmtree(d, ignore_errors=True)
        return len(pkgs)

    def gc(self, max_age_days: float) -> int:
        """Remove packages committed more than ``max_age_days`` ago."""
        cutoff = time.time() - max_age_days * 86400.0
        old = [d for d in self.packages()
               if (d / "_manifest.json").stat().st_mtime < cutoff]
        for d in old:
            shutil.rmtree(d, ignore_errors=True)
        return len(old)
