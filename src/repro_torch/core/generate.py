"""Generation GPO (paper Fig 5 ③) — renders the library source tree.

Two steps, as in the paper: (1) emit all SRU classes; (2) for every primitive
with a selected implementation, emit a helper "class template" with per-ctype
specializations plus a public function that forwards to it.

Stage-1 rendering (impl bodies are themselves Jinja2 templates over the SRU
data model) happens here, then identical rendered bodies are coalesced so one
specialization can cover many ctypes — the Python analogue of partial
specialization "reducing the number of specializations significantly".
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any

from . import engine
from .model import GenerationResult, GeneratedFile, PrimitiveDef, Selection


@dataclass
class _SpecView:
    fn_name: str
    body: str
    doc: str
    ctypes: list[str] = field(default_factory=list)


def _stage1(ctx: GenerationResult, prim: PrimitiveDef, sel: Selection) -> str:
    sru = ctx.targets[sel.target].as_render_dict()
    body = engine.render_stage1(
        sel.impl.implementation,
        sru=sru,
        ctype=sel.ctype,
        primitive=prim.name,
        params=prim.arg_names(),
    )
    return body if body.strip() else "pass"


def _render_helpers(ctx: GenerationResult, prim: PrimitiveDef, sel: Selection) -> str:
    if not sel.impl.helpers.strip():
        return ""
    sru = ctx.targets[sel.target].as_render_dict()
    return engine.render_stage1(
        sel.impl.helpers, sru=sru, ctype=sel.ctype, primitive=prim.name,
        params=prim.arg_names(),
    )


def _fwd_args(prim: PrimitiveDef) -> str:
    parts = []
    for p in prim.parameters:
        if "keyword_only" in p.attributes or p.default is not None:
            parts.append(f"{p.name}={p.name}")
        else:
            parts.append(p.name)
    return ", ".join(parts)


class GenerateGPO:
    name = "generate"

    def run(self, ctx: GenerationResult) -> GenerationResult:
        if ctx.errors:
            return ctx
        target = ctx.targets[ctx.config.target]
        tdict = target.as_render_dict()

        # step 1 — SRU class (paper: "all available SRUs are created as classes";
        # we emit the one relevant SRU — relevance filter, Fig 5 ②)
        ctx.files.append(GeneratedFile(
            relpath="_target.py",
            content=engine.render_template("sru.py.j2", target=tdict),
        ))

        # step 2 — primitives, grouped into modules
        groups: dict[str, list[str]] = collections.defaultdict(list)
        for name in ctx.selection:
            groups[ctx.primitives[name].group].append(name)

        cost_model: dict[str, dict[str, str]] = {}
        for group in sorted(groups):
            prim_views = []
            helper_blocks = []
            seen_helpers: set[str] = set()
            for name in sorted(groups[group]):
                prim = ctx.primitives[name]
                sels = ctx.selection[name]
                view = self._primitive_view(ctx, prim, sels)
                prim_views.append(view)
                for h in view.pop("_helpers"):
                    if h and h not in seen_helpers:
                        seen_helpers.add(h)
                        helper_blocks.append({"primitive": name, "code": h})
                # cost metadata: any selected impl may carry formulas
                for sel in sels.values():
                    if sel.impl.cost:
                        cost_model[name] = sel.impl.cost
                        break
            ctx.files.append(GeneratedFile(
                relpath=f"ops_{group}.py",
                content=engine.render_template(
                    "group_module.py.j2",
                    group=group,
                    target=tdict,
                    hw_flags=ctx.meta.get("hardware_flags", []),
                    helper_blocks=helper_blocks,
                    primitives=[_DotDict(v) for v in prim_views],
                ),
            ))

        ctx.files.append(GeneratedFile(
            relpath="ops.py",
            content=engine.render_template("ops.py.j2", groups=sorted(groups)),
        ))
        ctx.files.append(GeneratedFile(
            relpath="_cost.py",
            content=engine.render_template("cost.py.j2", cost_model=cost_model),
        ))
        ctx.files.append(GeneratedFile(
            relpath="__init__.py",
            content=engine.render_template(
                "init.py.j2",
                target=tdict,
                n_primitives=len(ctx.selection),
                groups=sorted(groups),
                primitive_names=sorted(ctx.selection),
                fingerprint=ctx.meta.get("fingerprint", ""),
            ),
        ))
        ctx.meta["groups"] = sorted(groups)
        return ctx

    # ------------------------------------------------------------------

    def _primitive_view(self, ctx: GenerationResult, prim: PrimitiveDef,
                        sels: dict[str, Selection]) -> dict[str, Any]:
        # stage-1 render every ctype, coalesce identical bodies
        by_body: dict[str, _SpecView] = {}
        helpers: list[str] = []
        order: list[str] = []
        for ctype, sel in sorted(sels.items()):
            body = _stage1(ctx, prim, sel)
            h = _render_helpers(ctx, prim, sel)
            if h:
                helpers.append(h)
            if body not in by_body:
                short = engine.dtype_info(ctype)["short"]
                by_body[body] = _SpecView(
                    fn_name=f"_{prim.name}__{short}",
                    body=body,
                    doc=(f"{prim.name} specialization "
                         f"[target={sel.target} native={sel.impl.is_native} "
                         f"score={sel.score} candidates={sel.candidates}]"),
                )
                order.append(body)
            by_body[body].ctypes.append(ctype)

        specs = []
        for body in order:
            sv = by_body[body]
            if len(sv.ctypes) == len(sels) and len(order) == 1:
                sv.fn_name = f"_{prim.name}__generic"
            specs.append(sv)

        table = {}
        for sv in specs:
            for ct in sv.ctypes:
                table[ct] = sv.fn_name

        any_sel = next(iter(sels.values()))
        dispatch_arg = prim.dispatch_param()
        default_ct = ctx.targets[any_sel.target].default_ctype
        if default_ct not in table:
            # fall back to any available specialization (also the dispatch
            # fallback slot, so it must always resolve)
            default_ct = next(iter(table))
        return {
            "name": prim.name,
            "brief": prim.brief,
            "sig": prim.signature(),
            "fwd_args": _fwd_args(prim),
            "dispatch_arg": dispatch_arg,
            "dispatch_desc": dispatch_arg or "static",
            "default_ctype": default_ct,
            "specializations": [
                {"fn_name": s.fn_name, "body": s.body, "doc": s.doc} for s in specs
            ],
            "table": table,
            "selection_note": "; ".join(
                f"{ct}->{sels[ct].impl.target_extension}"
                f"(score={sels[ct].score},loc={sels[ct].impl.loc},"
                f"native={sels[ct].impl.is_native},by={sels[ct].reason})"
                for ct in sorted(sels)
            ),
            "_helpers": helpers,
        }


class _DotDict(dict):
    __getattr__ = dict.__getitem__
