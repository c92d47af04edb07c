"""CLI for the port's generator (mirrors ``repro.core.cli``):

    python -m repro_torch.core generate --targets torch_cpu,h100
    python -m repro_torch.core generate --all --force
    python -m repro_torch.core corpus --warnings
    python -m repro_torch.core cache stats
    python -m repro_torch.core cache clear
    python -m repro_torch.core cache gc --max-age-days 30

Generating for ``h100`` on a host without a card only renders and stores
the package (cross-generation); nothing of it runs. The reference's
``bench`` and ``analyze`` commands wait for the port's bench selection and
static analysis.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--upd-path", action="append", default=[],
                    help="extra UPD search path (repeatable)")
    ap.add_argument("--build-root", default=None,
                    help="artifact cache root (default: build/tsl_torch)")


def _cmd_generate(args) -> int:
    from .corpus import load_corpus
    from .library import generate_all

    upd_paths = tuple(args.upd_path)
    corpus = load_corpus(upd_paths)
    if args.all:
        targets = None
    elif args.targets:
        targets = [t for chunk in args.targets for t in chunk.split(",") if t]
    else:
        print("error: pass --targets a,b,... or --all", file=sys.stderr)
        return 2
    unknown = sorted(set(targets or ()) - set(corpus.targets))
    if unknown:
        print(f"error: unknown target(s) {unknown}; the corpus defines "
              f"{sorted(corpus.targets)}", file=sys.stderr)
        return 2
    out = generate_all(targets, Path(args.build_root) if args.build_root else None,
                       force=args.force, corpus=corpus, upd_paths=upd_paths,
                       only=tuple(args.only) if args.only else None)
    for name, pkg_dir in out.items():
        print(f"{name}: {pkg_dir}")
    return 0


def _cmd_corpus(args) -> int:
    from .corpus import load_corpus

    corpus = load_corpus(tuple(args.upd_path))
    print(json.dumps({"fingerprint": corpus.fingerprint,
                      "targets": sorted(corpus.targets),
                      "primitives": len(corpus.primitives),
                      "tests": sum(len(p.tests) for p in corpus.primitives.values()),
                      "warnings": len(corpus.warnings)}, indent=1))
    if args.warnings:
        for w in corpus.warnings:
            print(f"  warning: {w}")
    return 0


def _cmd_cache(args) -> int:
    from .cache import ArtifactCache
    from .library import DEFAULT_BUILD_ROOT

    store = ArtifactCache(Path(args.build_root) if args.build_root else DEFAULT_BUILD_ROOT)
    if args.action == "stats":
        print(json.dumps(store.stats(), indent=1))
    elif args.action == "gc":
        if args.max_age_days is None:
            print("error: cache gc requires --max-age-days N", file=sys.stderr)
            return 2
        print(f"removed {store.gc(args.max_age_days)} expired package(s)")
    else:  # clear
        print(f"removed {store.clear()} cached package(s)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate libraries for target(s)")
    _add_common(g)
    g.add_argument("--targets", action="append", default=[],
                   help="comma-separated target names (repeatable)")
    g.add_argument("--all", action="store_true", help="every target the corpus defines")
    g.add_argument("--only", action="append", default=[],
                   help="cherry-picked primitive (repeatable; paper 'slim')")
    g.add_argument("--force", action="store_true", help="regenerate even on a cache hit")
    g.set_defaults(fn=_cmd_generate)

    c = sub.add_parser("corpus", help="validate + summarize the UPD corpus")
    _add_common(c)
    c.add_argument("--warnings", action="store_true", help="print every corpus warning")
    c.set_defaults(fn=_cmd_corpus)

    k = sub.add_parser("cache", help="artifact-cache maintenance")
    _add_common(k)
    k.add_argument("action", choices=("stats", "clear", "gc"))
    k.add_argument("--max-age-days", type=float, default=None,
                   help="gc: remove packages older than this many days")
    k.set_defaults(fn=_cmd_cache)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
