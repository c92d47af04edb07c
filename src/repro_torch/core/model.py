"""Data model for the TSLGen generator (PyTorch port) (paper §3.1/§3.2 ⑤).

The paper's UPD ("user provided data") consists of two document families:

* **SRUs** ("SISE representation units", here: hardware-target representation
  units) — one YAML document per execution target (``tsl_data/targets/*.yaml``).
* **Primitives** — one YAML document per primitive, each carrying one or more
  *definitions* (per-target implementations guarded by required feature flags,
  the analogue of the paper's ``lscpu_flags``), plus optional *tests* consumed
  by the test-generation GPO (paper §4.1).

These dataclasses are produced by the validation GPO after schema
checking/enrichment; downstream GPOs operate only on these types.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Any, Mapping


@dataclass(frozen=True)
class TargetDef:
    """An SRU: everything the generator knows about one execution target.

    The paper's SRU captures register/mask types and register width; the
    GPU analogue captures warp width (``lanes``), shared memory a block may
    use (``vmem_bytes``), device memory and roofline constants.
    """

    name: str
    vendor: str
    flags: tuple[str, ...]              # provided feature flags (lscpu_flags analogue)
    ctypes: tuple[str, ...]             # supported element types
    default_ctype: str
    lanes: int                          # threads per warp
    sublanes: int                       # warps per warpgroup
    mxu: tuple[int, int]                # tensor-core instruction tile (rows, cols)
    vmem_bytes: int                     # shared memory one block may use
    hbm_bytes: int
    peak_flops_bf16: float              # per-chip peak, FLOP/s
    hbm_bw: float                       # bytes/s
    ici_bw: float                       # bytes/s per link (NVLink, each way)
    ici_links: int
    interpret: bool = False             # kept for schema parity; unused
    runs_on_host: bool = True           # can impls execute in this process?
    dtype_map: dict[str, str] = field(default_factory=dict)   # ctype -> short name (paper: Neon naming scheme)
    description: str = ""
    extra: dict[str, Any] = field(default_factory=dict)       # schema allows arbitrary extra fields

    def as_render_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


@dataclass(frozen=True)
class ParamDef:
    name: str
    ctype: str = "register"             # semantic type tag (register/mask/scalar/shape/...)
    default: str | None = None          # python literal source or None (positional)
    attributes: tuple[str, ...] = ()    # e.g. ("keyword_only",)
    description: str = ""


@dataclass(frozen=True)
class ImplDef:
    """One per-target implementation of a primitive (paper Fig 6a ``definitions``)."""

    target_extension: str
    ctypes: tuple[str, ...]
    flags: tuple[str, ...]              # required feature flags (paper: lscpu_flags)
    implementation: str                 # python function body (Jinja2-renderable, stage-1)
    is_native: bool = True              # paper §3.2: maps directly to hw capability?
    helpers: str = ""                   # module-level code rendered once (imports, defs)
    cost: dict[str, str] = field(default_factory=dict)  # beyond-paper: flops/bytes formulas
    note: str = ""
    lint: dict[str, Any] = field(default_factory=dict)  # {"suppress": ["TSL0xx", ...]}

    @property
    def loc(self) -> int:
        """Lines of code — the paper's tie-breaker in the selection heuristic."""
        return sum(1 for ln in self.implementation.splitlines() if ln.strip())


@dataclass(frozen=True)
class TestDef:
    """A test case co-located with the primitive (paper §4.1)."""

    __test__ = False                    # not a pytest class, despite the name

    name: str
    implementation: str
    requires: tuple[str, ...] = ()      # primitive dependencies -> test DAG edges


@dataclass(frozen=True)
class PrimitiveDef:
    name: str
    group: str                          # output module grouping (calc/mask/reduce/nn/...)
    brief: str
    parameters: tuple[ParamDef, ...]
    returns_ctype: str
    definitions: tuple[ImplDef, ...]
    tests: tuple[TestDef, ...] = ()
    dispatch: str = "auto"              # "auto" | "none" | parameter name
    bench: dict[str, Any] | None = None  # sample-input factory for benchgen
    cost_shapes: tuple[str, ...] = ()   # shape symbols cost: formulas may use
    lint: dict[str, Any] = field(default_factory=dict)  # {"suppress": ["TSL0xx", ...]}
    extra: dict[str, Any] = field(default_factory=dict)

    def dispatch_param(self) -> str | None:
        """Name of the parameter whose dtype drives specialization dispatch."""
        if self.dispatch == "none":
            return None
        if self.dispatch != "auto":
            return self.dispatch
        for p in self.parameters:
            if p.ctype in ("register", "mask"):
                return p.name
        return None

    def signature(self) -> str:
        """Python signature source for the generated public function."""
        parts: list[str] = []
        kw_started = False
        for p in self.parameters:
            kw = "keyword_only" in p.attributes
            if kw and not kw_started:
                parts.append("*")
                kw_started = True
            parts.append(p.name if p.default is None else f"{p.name}={p.default}")
        return ", ".join(parts)

    def arg_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.parameters)


@dataclass
class Selection:
    """Result of the selection GPO for one (target, primitive, ctype)."""

    primitive: str
    target: str
    ctype: str
    impl: ImplDef
    score: int                          # number of matched required flags
    candidates: int                     # how many implementations were valid
    reason: str = ""                    # human-readable provenance ("flags", "bench", ...)


@dataclass
class GeneratedFile:
    relpath: str
    content: str
    kind: str = "code"                  # code | test | build | doc


@dataclass
class CorpusBuild:
    """Mutable state flowing through the *corpus* pipeline (load → validate).

    Target-agnostic: loading, template checking, schema validation and
    enrichment happen once per UPD fingerprint, not once per generation
    target.  ``freeze()`` produces the immutable :class:`CorpusIR` every
    per-target pipeline run shares.
    """

    upd_paths: tuple[str, ...] = ()
    fingerprint: str = ""
    raw_targets: list[dict] = field(default_factory=list)
    raw_primitives: list[dict] = field(default_factory=list)
    targets: dict[str, TargetDef] = field(default_factory=dict)
    primitives: dict[str, PrimitiveDef] = field(default_factory=dict)
    warnings: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)

    def fail(self, msg: str) -> None:
        self.errors.append(msg)

    def freeze(self) -> "CorpusIR":
        return CorpusIR(
            fingerprint=self.fingerprint,
            upd_paths=self.upd_paths,
            targets=MappingProxyType(dict(self.targets)),
            primitives=MappingProxyType(dict(self.primitives)),
            warnings=tuple(self.warnings),
        )


@dataclass(frozen=True)
class CorpusIR:
    """Immutable, target-agnostic view of the validated UPD corpus.

    Built once per UPD fingerprint and shared by every per-target generation
    run — the corpus half of the corpus/target split (paper §4.2 "ongoing
    process": regeneration for another target must not re-validate)."""

    fingerprint: str
    upd_paths: tuple[str, ...]
    targets: Mapping[str, TargetDef]
    primitives: Mapping[str, PrimitiveDef]
    warnings: tuple[str, ...] = ()

    @classmethod
    def from_defs(cls, targets: dict[str, TargetDef] | None = None,
                  primitives: dict[str, PrimitiveDef] | None = None,
                  fingerprint: str = "adhoc",
                  upd_paths: tuple[str, ...] = ()) -> "CorpusIR":
        """Build a corpus directly from typed defs (tests, custom pipelines)."""
        return cls(
            fingerprint=fingerprint,
            upd_paths=upd_paths,
            targets=MappingProxyType(dict(targets or {})),
            primitives=MappingProxyType(dict(primitives or {})),
        )


@dataclass
class GenerationResult:
    """Per-target mutable state flowing through the *target* pipeline
    (select → generate).

    The corpus half (``corpus``) is immutable and shared; everything mutable
    here is specific to one (target, config) generation run."""

    config: "GenConfig"
    corpus: CorpusIR
    # selection[primitive][ctype] -> Selection  (for config.target only)
    selection: dict[str, dict[str, Selection]] = field(default_factory=dict)
    files: list[GeneratedFile] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def targets(self) -> Mapping[str, TargetDef]:
        return self.corpus.targets

    @property
    def primitives(self) -> Mapping[str, PrimitiveDef]:
        return self.corpus.primitives

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)

    def fail(self, msg: str) -> None:
        self.errors.append(msg)


@dataclass(frozen=True)
class GenConfig:
    """Generator invocation configuration (paper: CLI of ``main.py`` + cmake glue)."""

    target: str                          # SRU name to generate for
    hardware_flags: tuple[str, ...] | None = None   # override probed flags (paper: --targets)
    only: tuple[str, ...] | None = None  # cherry-picked primitive subset (paper §1 "slim")
    package_name: str = "tsl_torch"
    upd_paths: tuple[str, ...] = ()      # extra UPD search paths (extensibility studies)
    build_root: str | None = None        # artifact-cache root (None -> build/tsl_torch)
