"""Implementation-selection GPO (paper Fig 5 ②).

*"We implemented a heuristic model, which finds the highest match between the
required hardware capabilities of the user given implementation and the
actually available hardware features. The underlying idea is that if an
implementation uses more hardware-provided functionalities, the implementation
[...] is more specialized against the underlying hardware. If multiple variants
with the same similarity score exist, the implementations are sorted ascending
by the number of lines of code, and the first (i.e. shortest) implementation
is chosen."*

Also performs the *relevance filter*: only primitives/definitions for the
requested target (and the cherry-picked ``only`` subset plus transitive test
dependencies) survive — paper: "we can generate the complete library or only a
slim one on a per-use-case basis".
"""

from __future__ import annotations

from .model import GenerationResult, ImplDef, PrimitiveDef, Selection


def hardware_flags(ctx: GenerationResult) -> frozenset[str]:
    """Available feature flags: target SRU flags, optionally overridden by the
    user-supplied hardware description (paper: flags may be user input or
    probed from the OS)."""
    tgt = ctx.targets[ctx.config.target]
    if ctx.config.hardware_flags is not None:
        return frozenset(ctx.config.hardware_flags)
    return frozenset(tgt.flags)


def valid_candidates(prim: PrimitiveDef, target: str, ctype: str,
                     hw: frozenset[str]) -> list[ImplDef]:
    """Definitions that are well-formed on this hardware: right target, right
    ctype, and *all* required flags available."""
    return [
        d
        for d in prim.definitions
        if d.target_extension == target
        and ctype in d.ctypes
        and frozenset(d.flags) <= hw
    ]


def score(impl: ImplDef, hw: frozenset[str]) -> int:
    """Similarity score = number of hardware capabilities the implementation
    exercises (all of them are available, by candidate validity)."""
    return len(frozenset(impl.flags) & hw)


def choose(prim: PrimitiveDef, target: str, ctype: str, hw: frozenset[str]
           ) -> Selection | None:
    cands = valid_candidates(prim, target, ctype, hw)
    if not cands:
        return None
    ranked = sorted(
        cands,
        key=lambda d: (-score(d, hw), d.loc, prim.definitions.index(d)),
    )
    best = ranked[0]
    return Selection(
        primitive=prim.name,
        target=target,
        ctype=ctype,
        impl=best,
        score=score(best, hw),
        candidates=len(cands),
        reason="flags",
    )


def cherry_pick(ctx: GenerationResult) -> set[str]:
    """Resolve the ``only`` subset, closing over test dependencies so that the
    generated slim library still carries everything its tests need."""
    if ctx.config.only is None:
        return set(ctx.primitives)
    want = set(ctx.config.only)
    unknown = want - set(ctx.primitives)
    for u in sorted(unknown):
        ctx.fail(f"cherry-pick: unknown primitive {u!r}")
    frontier = list(want & set(ctx.primitives))
    seen = set(frontier)
    while frontier:
        p = frontier.pop()
        for t in ctx.primitives[p].tests:
            for dep in t.requires:
                if dep in ctx.primitives and dep not in seen:
                    seen.add(dep)
                    frontier.append(dep)
    return seen


class SelectGPO:
    name = "select"

    def run(self, ctx: GenerationResult) -> GenerationResult:
        target = ctx.config.target
        if target not in ctx.targets:
            ctx.fail(f"select: unknown target {target!r}")
            return ctx
        hw = hardware_flags(ctx)
        keep = cherry_pick(ctx)
        tgt = ctx.targets[target]
        for name in sorted(keep):
            prim = ctx.primitives[name]
            per_ctype: dict[str, Selection] = {}
            for ctype in tgt.ctypes:
                sel = choose(prim, target, ctype, hw)
                if sel is not None:
                    per_ctype[ctype] = sel
                    if not sel.impl.is_native:
                        # paper §3.2: non-native workaround -> build-time warning
                        ctx.warn(
                            f"primitive {name!r} [{target}/{ctype}]: selected "
                            f"implementation is a non-native workaround"
                        )
            if per_ctype:
                ctx.selection[name] = per_ctype
            else:
                ctx.warn(
                    f"primitive {name!r}: no valid implementation for target "
                    f"{target!r} — omitted from the generated library"
                )
        ctx.meta["hardware_flags"] = sorted(hw)
        return ctx
