"""TSLGen generator framework, PyTorch port (paper §3; mirrors ``repro.core``).

Public surface:
    load_library(target)        -> generated + imported TSL module
    generate_library(config)    -> on-disk package (artifact-cache aware)
    generate_all(targets)       -> many targets off ONE validated corpus
    load_corpus(upd_paths)      -> immutable CorpusIR (validation memo)
    ArtifactCache, CacheKey, GENERATOR_VERSION — content-addressed store
    GenConfig, Pipeline, CorpusPipeline, core_pipeline — extension port
"""

from .cache import GENERATOR_VERSION, ArtifactCache, CacheKey
from .corpus import CorpusPipeline, corpus_cache_clear, load_corpus
from .library import generate_all, generate_library, load_library
from .model import CorpusBuild, CorpusIR, GenConfig, GenerationResult
from .pipeline import GenerationError, Pipeline, core_pipeline

__all__ = [
    "load_library",
    "generate_library",
    "generate_all",
    "load_corpus",
    "corpus_cache_clear",
    "GenConfig",
    "CorpusBuild",
    "CorpusIR",
    "GenerationResult",
    "Pipeline",
    "CorpusPipeline",
    "core_pipeline",
    "GenerationError",
    "ArtifactCache",
    "CacheKey",
    "GENERATOR_VERSION",
]
