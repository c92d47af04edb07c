"""Schema DSL + validation for the UPD (paper §3.2 ⑥ "Schema Description").

The paper: *"Every entry has a name and an expected fundamental (e.g., string
or a list of strings) or composed type. [...] we distinguish between two types
of entries within a composed type: mandatory entries must be specified [...]
optional entries may or may not be specified [...] a default value is defined
for every optional entry. We also allow arbitrary additional fields beyond the
ones specified by the schema."*

YAML has no schema DSL, so — like the paper — we implement validation
ourselves.  ``Schema.apply`` returns the *enriched* document (defaults filled
in) plus error/warning lists; it never throws, so the validation GPO can
surface all problems at once (paper: "errors are prompted to the user").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

# ---------------------------------------------------------------------------
# fundamental types

_FUNDAMENTAL: dict[str, Callable[[Any], bool]] = {
    "str": lambda v: isinstance(v, str),
    "code": lambda v: isinstance(v, str),          # code block (rendered stage-1)
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "float": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "bool": lambda v: isinstance(v, bool),
    "list[str]": lambda v: isinstance(v, list) and all(isinstance(x, str) for x in v),
    "list[int]": lambda v: isinstance(v, list)
    and all(isinstance(x, int) and not isinstance(x, bool) for x in v),
    "dict": lambda v: isinstance(v, dict),
    "any": lambda v: True,
}


@dataclass(frozen=True)
class Entry:
    """One schema entry (paper ⑥): fundamental or composed, mandatory or optional."""

    name: str
    type: str = "str"                    # key into _FUNDAMENTAL, or "composed"/"list[composed]"
    mandatory: bool = False
    default: Any = None                  # required for optional entries (paper)
    child: "Schema | None" = None        # for composed / list[composed]
    choices: tuple[str, ...] | None = None
    description: str = ""

    def __post_init__(self):
        if self.type in ("composed", "list[composed]") and self.child is None:
            raise ValueError(f"entry {self.name!r}: composed type requires child schema")
        if self.type not in _FUNDAMENTAL and self.type not in ("composed", "list[composed]"):
            raise ValueError(f"entry {self.name!r}: unknown type {self.type!r}")


@dataclass(frozen=True)
class Schema:
    name: str
    entries: tuple[Entry, ...]
    allow_extra: bool = True             # paper: arbitrary additional fields allowed

    def entry_names(self) -> set[str]:
        return {e.name for e in self.entries}

    # -- validation ---------------------------------------------------------

    def apply(self, doc: Any, *, path: str = "") -> tuple[dict, list[str], list[str]]:
        """Validate + enrich ``doc``. Returns (enriched, errors, warnings)."""
        errors: list[str] = []
        warnings: list[str] = []
        loc = path or self.name
        if not isinstance(doc, dict):
            return {}, [f"{loc}: expected a mapping, got {type(doc).__name__}"], warnings

        out: dict[str, Any] = {}
        for e in self.entries:
            p = f"{loc}.{e.name}"
            if e.name not in doc:
                if e.mandatory:
                    errors.append(f"{p}: mandatory entry missing")
                else:
                    out[e.name] = _copy_default(e.default)
                continue
            v = doc[e.name]
            if e.type == "composed":
                sub, errs, warns = e.child.apply(v, path=p)
                out[e.name] = sub
                errors += errs
                warnings += warns
            elif e.type == "list[composed]":
                if not isinstance(v, list):
                    errors.append(f"{p}: expected a list, got {type(v).__name__}")
                    continue
                subs = []
                for i, item in enumerate(v):
                    sub, errs, warns = e.child.apply(item, path=f"{p}[{i}]")
                    subs.append(sub)
                    errors += errs
                    warnings += warns
                out[e.name] = subs
            else:
                if not _FUNDAMENTAL[e.type](v):
                    errors.append(
                        f"{p}: expected {e.type}, got {type(v).__name__} ({v!r})"
                    )
                    continue
                if e.choices is not None and v not in e.choices:
                    errors.append(f"{p}: {v!r} not in allowed choices {sorted(e.choices)}")
                    continue
                out[e.name] = v

        # arbitrary additional fields (paper ⑥): pass through, but surface them
        for k, v in doc.items():
            if k not in self.entry_names():
                if self.allow_extra:
                    out[k] = v
                    warnings.append(f"{loc}.{k}: extra field passed through (not in schema)")
                else:
                    errors.append(f"{loc}.{k}: unknown field")
        return out, errors, warnings


def _copy_default(v: Any) -> Any:
    if isinstance(v, (list, dict)):
        import copy

        return copy.deepcopy(v)
    return v


# ---------------------------------------------------------------------------
# concrete schemas — inferred bottom-up from the templates (paper ⑥, footnote 4)

PARAM_SCHEMA = Schema(
    "parameter",
    (
        Entry("name", "str", mandatory=True),
        Entry("ctype", "str", default="register"),
        Entry("default", "any", default=None),
        Entry("attributes", "list[str]", default=[]),
        Entry("description", "str", default=""),
    ),
)

DEFINITION_SCHEMA = Schema(
    "definition",
    (
        # str, or list[str] (compact multi-target definition; expanded by the
        # validation GPO into one ImplDef per target)
        Entry("target_extension", "any", mandatory=True),
        Entry("ctype", "list[str]", mandatory=True),
        Entry("lscpu_flags", "list[str]", default=[]),       # paper's key name, kept verbatim
        Entry("implementation", "code", mandatory=True),
        Entry("is_native", "bool", default=True),            # paper §3.2
        Entry("helpers", "code", default=""),
        Entry("cost", "dict", default={}),
        Entry("note", "str", default=""),
        # per-definition analysis suppression: lint: {suppress: [TSL0xx, ...]}
        Entry("lint", "dict", default={}),
    ),
)

TEST_SCHEMA = Schema(
    "test",
    (
        Entry("name", "str", mandatory=True),
        Entry("implementation", "code", mandatory=True),
        Entry("requires", "list[str]", default=[]),
    ),
)

PRIMITIVE_SCHEMA = Schema(
    "primitive",
    (
        Entry("primitive_name", "str", mandatory=True),
        Entry("group", "str", default="misc"),
        Entry("brief", "str", default=""),
        Entry("parameters", "list[composed]", default=[], child=PARAM_SCHEMA),
        Entry(
            "returns",
            "composed",
            default={"ctype": "register"},
            child=Schema("returns", (Entry("ctype", "str", default="register"),)),
        ),
        Entry("definitions", "list[composed]", mandatory=True, child=DEFINITION_SCHEMA),
        Entry("testing", "list[composed]", default=[], child=TEST_SCHEMA),
        # dispatch: "auto" = dtype of first register param, "none" = single
        # specialization (default_ctype), or an explicit parameter name.
        Entry("dispatch", "str", default="auto"),
        # shape-symbol vocabulary the cost: formulas may reference — the
        # keyword set callers pass to the generated cost(); checked by
        # TSL-Check (TSL012/TSL013).
        Entry("cost_shapes", "list[str]", default=[]),
        # primitive-wide analysis suppression: lint: {suppress: [TSL0xx, ...]}
        Entry("lint", "dict", default={}),
        # bench: sample-input factory enabling benchmark-driven adaptive
        # variant selection (beyond-paper, paper §4.2 future work).
        Entry(
            "bench",
            "composed",
            default=None,
            child=Schema(
                "bench",
                (
                    Entry("setup", "code", mandatory=True),
                    Entry("n_iter", "int", default=30),
                ),
            ),
        ),
    ),
)

TARGET_SCHEMA = Schema(
    "target",
    (
        Entry("name", "str", mandatory=True),
        Entry("vendor", "str", default="unknown"),
        Entry("lscpu_flags", "list[str]", mandatory=True),
        Entry("ctypes", "list[str]", mandatory=True),
        Entry("default_ctype", "str", default="float32"),
        Entry("lanes", "int", default=32),
        Entry("sublanes", "int", default=1),
        Entry("mxu", "list[int]", default=[1, 1]),
        Entry("vmem_bytes", "int", default=0),
        Entry("hbm_bytes", "int", default=0),
        # roofline figures price serving admission: no silent default
        Entry("peak_flops_bf16", "float", mandatory=True),
        Entry("hbm_bw", "float", mandatory=True),
        Entry("ici_bw", "float", default=0.0),
        Entry("ici_links", "int", default=0),
        Entry("interpret", "bool", default=False),
        Entry("runs_on_host", "bool", default=True),
        # torch device the target's tensors live on: load/set/set1 create
        # their tensors there, generated tests too. No default: a card
        # target that left it out would build host tensors unnoticed
        Entry("device", "str", mandatory=True, choices=("cpu", "cuda")),
        Entry("dtype_map", "dict", default={}),
        Entry("description", "str", default=""),
    ),
)
