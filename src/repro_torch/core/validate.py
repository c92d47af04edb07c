"""Validation/enrichment GPO (paper Fig 5 ①, first pipeline operator).

*"The very first GPO validates the input provided to the generator. While this
step may be omitted, it can be very beneficial when searching for errors
within the input and enriching the provided user data."*

Converts raw YAML docs → typed ``TargetDef``/``PrimitiveDef`` after schema
application; collects all errors before failing.

Corpus-phase GPO: validation is target-agnostic, so it runs ONCE per UPD
fingerprint (on a :class:`~.model.CorpusBuild`) no matter how many targets
are subsequently generated from the shared corpus.
"""

from __future__ import annotations

from . import schema as S
from .model import CorpusBuild, ImplDef, ParamDef, PrimitiveDef, TargetDef, TestDef


class ValidateGPO:
    name = "validate"

    def run(self, ctx: CorpusBuild) -> CorpusBuild:
        self._targets(ctx)
        self._primitives(ctx)
        self._cross_check(ctx)
        return ctx

    # -- targets ------------------------------------------------------------

    def _targets(self, ctx: CorpusBuild) -> None:
        for raw in ctx.raw_targets:
            raw = {k: v for k, v in raw.items() if not k.startswith("__")}
            doc, errs, warns = S.TARGET_SCHEMA.apply(raw)
            ctx.errors += errs
            ctx.warnings += [w for w in warns if ".__" not in w]
            if errs:
                continue
            known = S.TARGET_SCHEMA.entry_names()
            extra = {k: v for k, v in doc.items() if k not in known}
            t = TargetDef(
                name=doc["name"],
                vendor=doc["vendor"],
                flags=tuple(doc["lscpu_flags"]),
                ctypes=tuple(doc["ctypes"]),
                default_ctype=doc["default_ctype"],
                lanes=doc["lanes"],
                sublanes=doc["sublanes"],
                mxu=tuple(doc["mxu"]),
                vmem_bytes=doc["vmem_bytes"],
                hbm_bytes=doc["hbm_bytes"],
                peak_flops_bf16=float(doc["peak_flops_bf16"]),
                hbm_bw=float(doc["hbm_bw"]),
                ici_bw=float(doc["ici_bw"]),
                ici_links=doc["ici_links"],
                interpret=doc["interpret"],
                runs_on_host=doc["runs_on_host"],
                device=doc["device"],
                dtype_map=doc["dtype_map"],
                description=doc["description"],
                extra=extra,
            )
            if t.name in ctx.targets:
                ctx.fail(f"duplicate target {t.name!r}")
            ctx.targets[t.name] = t

    # -- primitives ----------------------------------------------------------

    def _primitives(self, ctx: CorpusBuild) -> None:
        for raw in ctx.raw_primitives:
            raw = {k: v for k, v in raw.items() if not k.startswith("__")}
            doc, errs, warns = S.PRIMITIVE_SCHEMA.apply(raw)
            ctx.errors += errs
            if errs:
                continue
            params = tuple(
                ParamDef(
                    name=p["name"],
                    ctype=p["ctype"],
                    default=(None if p["default"] is None else repr(p["default"])
                             if not isinstance(p["default"], str) else p["default"]),
                    attributes=tuple(p["attributes"]),
                    description=p["description"],
                )
                for p in doc["parameters"]
            )
            defs_list: list[ImplDef] = []
            for d in doc["definitions"]:
                tgts = d["target_extension"]
                if isinstance(tgts, str):
                    tgts = [tgts]
                if not (isinstance(tgts, list) and all(isinstance(t, str) for t in tgts)):
                    ctx.fail(
                        f"primitive {doc['primitive_name']!r}: target_extension must "
                        f"be str or list[str], got {tgts!r}"
                    )
                    continue
                for tgt_name in tgts:
                    defs_list.append(ImplDef(
                        target_extension=tgt_name,
                        ctypes=tuple(d["ctype"]),
                        flags=tuple(d["lscpu_flags"]),
                        implementation=d["implementation"],
                        is_native=d["is_native"],
                        helpers=d["helpers"],
                        cost={k: str(v) for k, v in d["cost"].items()},
                        note=d["note"],
                        lint=d["lint"],
                    ))
            defs = tuple(defs_list)
            tests = tuple(
                TestDef(
                    name=t["name"],
                    implementation=t["implementation"],
                    requires=tuple(t["requires"]),
                )
                for t in doc["testing"]
            )
            known = S.PRIMITIVE_SCHEMA.entry_names()
            extra = {k: v for k, v in doc.items() if k not in known}
            prim = PrimitiveDef(
                name=doc["primitive_name"],
                group=doc["group"],
                brief=doc["brief"],
                parameters=params,
                returns_ctype=doc["returns"]["ctype"],
                definitions=defs,
                tests=tests,
                dispatch=doc["dispatch"],
                bench=doc["bench"],
                cost_shapes=tuple(doc["cost_shapes"]),
                lint=doc["lint"],
                extra=extra,
            )
            if prim.name in ctx.primitives:
                ctx.fail(f"duplicate primitive {prim.name!r}")
            ctx.primitives[prim.name] = prim

    # -- cross checks ---------------------------------------------------------

    def _cross_check(self, ctx: CorpusBuild) -> None:
        for prim in ctx.primitives.values():
            for d in prim.definitions:
                if d.target_extension not in ctx.targets:
                    ctx.fail(
                        f"primitive {prim.name!r}: definition references unknown "
                        f"target {d.target_extension!r}"
                    )
                    continue
                tgt = ctx.targets[d.target_extension]
                for ct in d.ctypes:
                    if ct not in tgt.ctypes:
                        ctx.warn(
                            f"primitive {prim.name!r}: ctype {ct!r} not listed for "
                            f"target {d.target_extension!r}"
                        )
            if not prim.tests:
                # paper §4.1: "If no test cases are defined, a warning will be emitted."
                ctx.warn(f"primitive {prim.name!r}: no test cases defined")
        # NOTE: existence of the *requested* generation target is a target-phase
        # concern now (SelectGPO fails on unknown targets); the corpus itself
        # is target-agnostic.
