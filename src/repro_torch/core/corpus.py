"""Corpus pipeline: load + template-check + validate the UPD once per
fingerprint (the corpus half of the corpus/target split).

The paper re-runs the whole pipeline per invocation; with many targets that
means re-parsing and re-validating an identical corpus N times.  Here the
corpus phase produces an immutable :class:`~.model.CorpusIR` memoised on the
UPD content fingerprint, so ``generate_all(targets)`` validates exactly once
and a fingerprint change (edited UPD document, template, or generator source)
transparently rebuilds it — incremental invalidation, paper §4.2 "ongoing
process".
"""

from __future__ import annotations

from . import loader
from .model import CorpusBuild, CorpusIR
from .pipeline import GenerationError, OperatorList, TemplateCheckGPO


class CorpusPipeline(OperatorList):
    """Corpus-phase pipeline: target-agnostic GPOs only."""

    def __init__(self, operators=None):
        if operators is None:
            from .validate import ValidateGPO

            operators = [TemplateCheckGPO(), ValidateGPO()]
        super().__init__(operators)

    def build(self, upd_paths: tuple[str, ...] = (), *,
              fingerprint: str | None = None, strict: bool = True) -> CorpusIR:
        cb = CorpusBuild(upd_paths=tuple(upd_paths))
        cb.raw_targets = loader.load_raw_targets(cb.upd_paths)
        cb.raw_primitives = loader.load_raw_primitives(cb.upd_paths)
        cb.fingerprint = fingerprint or loader.upd_fingerprint(cb.upd_paths)
        for op in self.operators:
            cb = op.run(cb)
            if cb.errors and strict:
                raise GenerationError(cb.errors, cb.warnings)
        return cb.freeze()


# fingerprint-keyed corpus memo: validation runs once per distinct UPD content
_CORPUS_CACHE: dict[tuple[str, tuple[str, ...]], CorpusIR] = {}


def load_corpus(upd_paths: tuple[str, ...] = (), *,
                fingerprint: str | None = None,
                force: bool = False) -> CorpusIR:
    """Return the validated corpus for ``upd_paths``, building it at most once
    per content fingerprint. Editing any UPD/template/generator file changes
    the fingerprint and forces a rebuild; everything else is a memo hit.

    ``fingerprint`` lets callers that already hashed the UPD tree (e.g. the
    artifact-key computation) skip re-hashing it for the memo key."""
    upd_paths = tuple(upd_paths)
    if fingerprint is None:
        fingerprint = loader.upd_fingerprint(upd_paths)
    key = (fingerprint, upd_paths)
    if not force and key in _CORPUS_CACHE:
        return _CORPUS_CACHE[key]
    corpus = CorpusPipeline().build(upd_paths, fingerprint=fingerprint)
    _CORPUS_CACHE[key] = corpus
    return corpus


def corpus_cache_clear() -> None:
    _CORPUS_CACHE.clear()
