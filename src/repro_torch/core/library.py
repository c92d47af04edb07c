"""Public generator API: generate → materialize on disk → import.

The C++ TSL is generated into a header tree and compiled into the consumer;
the port generates a Python package whose primitive bodies are torch code
into the artifact cache under ``build/tsl_torch/`` and imports it.

* the corpus (loaded + validated UPD) is built once per fingerprint and
  shared across targets — ``generate_all`` re-validates nothing when
  generating a second target;
* every generated package is content-addressed by
  (UPD fingerprint, target, hardware flags, generator version, variant), so
  ``load_library()`` with unchanged inputs is a cache hit that runs no GPO.
"""

from __future__ import annotations

import dataclasses
import importlib
import shutil
import sys
from pathlib import Path
from types import ModuleType

from . import loader
from .cache import GENERATOR_VERSION, ArtifactCache, CacheKey, variant_digest
from .corpus import load_corpus
from .model import CorpusIR, GenConfig, GenerationResult
from .pipeline import core_pipeline

DEFAULT_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "tsl_torch"

_IN_PROCESS_CACHE: dict[str, ModuleType] = {}


def effective_hardware_flags(config: GenConfig,
                             corpus: CorpusIR | None = None) -> tuple[str, ...]:
    """The hardware flags that key this generation run: the explicit
    override if given, else the target SRU's own flags (read from the raw
    UPD on warm paths — a cache hit must not pay for validation)."""
    if config.hardware_flags is not None:
        return tuple(sorted(config.hardware_flags))
    if corpus is not None and config.target in corpus.targets:
        return tuple(sorted(corpus.targets[config.target].flags))
    for doc in loader.load_raw_targets(config.upd_paths):
        if doc.get("name") == config.target:
            return tuple(sorted(doc.get("lscpu_flags", ())))
    return ()


def artifact_key(config: GenConfig, fingerprint: str,
                 corpus: CorpusIR | None = None) -> CacheKey:
    return CacheKey(
        fingerprint=fingerprint,
        target=config.target,
        hardware_flags=effective_hardware_flags(config, corpus),
        generator_version=GENERATOR_VERSION,
        variant=variant_digest(config),
    )


def generate_library(config: GenConfig, build_root: Path | None = None,
                     *, force: bool = False,
                     corpus: CorpusIR | None = None
                     ) -> tuple[Path, GenerationResult | None]:
    """Run the target pipeline (or hit the artifact cache) for one target.

    Returns (pkg_dir, result); result is None on a cache hit — no GPO ran."""
    fingerprint = (corpus.fingerprint if corpus is not None
                   else loader.upd_fingerprint(config.upd_paths))
    key = artifact_key(config, fingerprint, corpus)
    build_root = Path(build_root or config.build_root or DEFAULT_BUILD_ROOT)
    store = ArtifactCache(build_root)
    pkg = store.package_name(config.package_name, key)
    hit = store.lookup(pkg)
    if hit is not None:
        if not force:
            return hit, None
        shutil.rmtree(hit)
    if corpus is None:
        corpus = load_corpus(config.upd_paths, fingerprint=fingerprint)
    run_cfg = dataclasses.replace(config, package_name=pkg,
                                  build_root=str(build_root))
    result = core_pipeline(run_cfg).run(run_cfg, corpus=corpus)
    return store.commit(pkg, key, result.files), result


def generate_all(targets: tuple[str, ...] | list[str] | None = None,
                 build_root: Path | None = None, *, force: bool = False,
                 corpus: CorpusIR | None = None,
                 upd_paths: tuple[str, ...] = ()) -> dict[str, Path]:
    """Generate libraries for several targets off ONE shared corpus
    (``targets=None``: every target the corpus defines). Cross-generation
    for a target this host cannot run (``h100`` on a CPU host) only renders
    and stores the package; nothing of it is executed."""
    if corpus is None:
        corpus = load_corpus(tuple(upd_paths))
    names = list(targets) if targets is not None else sorted(corpus.targets)
    out: dict[str, Path] = {}
    for name in names:
        cfg = GenConfig(target=name, upd_paths=tuple(upd_paths))
        out[name], _ = generate_library(cfg, build_root, force=force,
                                        corpus=corpus)
    return out


def load_library(target: str, *, only: tuple[str, ...] | None = None,
                 hardware_flags: tuple[str, ...] | None = None,
                 upd_paths: tuple[str, ...] = (),
                 build_root: Path | None = None,
                 force: bool = False) -> ModuleType:
    """Generate (cached) and import the TSL for ``target`` (an SRU name;
    ``repro_torch.tsl_api.lib`` resolves one from a device)."""
    config = GenConfig(
        target=target,
        hardware_flags=hardware_flags,
        only=tuple(only) if only else None,
        upd_paths=tuple(upd_paths),
    )
    pkg_dir, _ = generate_library(config, build_root, force=force)
    pkg = pkg_dir.name
    if pkg in _IN_PROCESS_CACHE and not force:
        return _IN_PROCESS_CACHE[pkg]
    pkg_root = str(pkg_dir.parent)
    if pkg_root not in sys.path:
        sys.path.insert(0, pkg_root)
    if force:
        for m in [m for m in sys.modules if m == pkg or m.startswith(pkg + ".")]:
            del sys.modules[m]
    mod = importlib.import_module(pkg)
    _IN_PROCESS_CACHE[pkg] = mod
    return mod
