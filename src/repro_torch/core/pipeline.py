"""GPO pipelines (paper Fig 5 ①).

*"We designed our generator core as a pipeline consisting of multiple
generator pipeline operators (GPO), where every GPO depends on the result of
the previous one. That way, the GPOs remain exchangeable, and the pipeline can
be altered in its behavior by changing an operator or expanded by adding
further operators."*

Since the incremental-engine refactor the GPOs are split into two phases:

* **corpus phase** (``corpus.CorpusPipeline``): template-check + validate,
  target-agnostic, run ONCE per UPD fingerprint, producing an immutable
  :class:`~.model.CorpusIR`.
* **target phase** (:class:`Pipeline` here): select → generate, run once
  per (target, config) on a shared corpus, producing a
  :class:`~.model.GenerationResult`.
"""

from __future__ import annotations

from typing import Protocol

from . import engine
from .model import GenConfig, GenerationResult


class GPO(Protocol):
    name: str

    def run(self, ctx): ...


class GenerationError(RuntimeError):
    def __init__(self, errors: list[str], warnings: list[str]):
        self.errors = errors
        self.warnings = warnings
        super().__init__(
            "TSLGen pipeline failed:\n" + "\n".join(f"  error: {e}" for e in errors)
        )


class TemplateCheckGPO:
    """Paper ①: 'every code template is loaded once into the framework and
    subsequently validated' — Jinja2 syntax errors surface here, not mid-render.
    Corpus-phase GPO: templates are target-agnostic, so one check covers every
    generation target."""

    name = "template-check"

    def run(self, ctx):
        env = engine.environment()
        for name in env.list_templates(filter_func=lambda n: n.endswith(".j2")):
            try:
                env.get_template(name)
            except Exception as e:  # pragma: no cover - template bugs
                ctx.fail(f"template {name!r}: {e}")
        return ctx


class OperatorList:
    """Exchangeability / extension port shared by both pipeline phases
    (paper Fig 5 ⑦)."""

    def __init__(self, operators: list[GPO]):
        self.operators = list(operators)

    def names(self) -> list[str]:
        return [op.name for op in self.operators]

    def append(self, op: GPO):
        self.operators.append(op)
        return self

    def insert_after(self, name: str, op: GPO):
        for i, existing in enumerate(self.operators):
            if existing.name == name:
                self.operators.insert(i + 1, op)
                return self
        raise KeyError(f"no GPO named {name!r}")

    def replace(self, name: str, op: GPO):
        for i, existing in enumerate(self.operators):
            if existing.name == name:
                self.operators[i] = op
                return self
        raise KeyError(f"no GPO named {name!r}")


class Pipeline(OperatorList):
    """The target-phase pipeline: runs per (target, config) on a shared,
    already-validated corpus."""

    def run(self, config: GenConfig, *, corpus=None,
            strict: bool = True) -> GenerationResult:
        if corpus is None:
            from .corpus import load_corpus

            corpus = load_corpus(config.upd_paths)
        ctx = GenerationResult(config=config, corpus=corpus,
                               warnings=list(corpus.warnings))
        ctx.meta["fingerprint"] = corpus.fingerprint
        for op in self.operators:
            ctx = op.run(ctx)
            if ctx.errors and strict:
                raise GenerationError(ctx.errors, ctx.warnings)
        return ctx


def core_pipeline(config: GenConfig) -> Pipeline:
    """The target-phase core (paper ①): select -> generate. The reference's
    extension GPOs (bench selection, test/build/doc generation) are not part
    of this port yet."""
    from .generate import GenerateGPO
    from .select import SelectGPO

    return Pipeline([SelectGPO(), GenerateGPO()])
