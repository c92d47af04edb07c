"""Test-generation GPO (paper §4.1; mirrors ``repro.core.testgen``).

Tests live inside the primitive UPD documents. We build a directed acyclic
dependency graph (node = primitive, edge a→b if one of b's tests requires
a), topologically sort it so *"a test is always executed after all of its
required precondition tests are passed"*, and mark tests whose dependencies
are untested as **unsafe** (runtime warning).

The paper embeds into Catch2; here it is pytest. Generated tests land in
``<pkg>/tests/test_generated.py`` in topological order, one function per
(primitive, test, ctype), plus a static helper module ``_testing.py`` (paper:
"powerful helper functions for setting up the test and tearing it down"):
its ``TestCtx`` makes seeded inputs on the target's device and compares
results on the host.
"""

from __future__ import annotations

import graphlib

from . import engine
from .model import GenerationResult, GeneratedFile

_TESTING_HELPERS = '''"""Generated by TSLGen (PyTorch port) — test helpers (paper §4.1)."""

import numpy as np
import torch

from ._target import TARGET


class TestCtx:
    """Set-up/tear-down helper: seeded numpy inputs as tensors on the
    target's device, and comparisons on the host in float64."""

    __test__ = False                    # not a pytest class, despite the name

    def __init__(self, seed: int = 0, device: str = TARGET.device):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def array(self, shape, ctype: str, lo=-4.0, hi=4.0) -> torch.Tensor:
        if ctype.startswith("uint"):
            lo = max(0, int(lo))
        if ctype.startswith(("int", "uint")):
            arr = self.rng.integers(int(lo), int(hi) + 1, size=shape).astype(ctype)
            return torch.from_numpy(arr).to(self.device)
        arr = self.rng.uniform(lo, hi, size=shape).astype("float32")
        return torch.from_numpy(arr).to(self.device, getattr(torch, ctype))

    @staticmethod
    def host(a) -> np.ndarray:
        """A tensor (any device; bf16 widened to f32) or array-like as numpy."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            return (a.float() if a.dtype in (torch.bfloat16, torch.float16) else a).numpy()
        return np.asarray(a)

    @classmethod
    def f64(cls, a) -> np.ndarray:
        return np.asarray(cls.host(a), dtype=np.float64)

    @classmethod
    def allclose(cls, a, b, ctype: str = "float32", scale: float = 1.0):
        if ctype.startswith(("int", "uint")):
            # integer lanes wrap modulo 2^bits — compare in wrapped space
            got = cls.host(a)
            want = cls.f64(b).astype(np.int64).astype(got.dtype)
            np.testing.assert_array_equal(got, want)
            return
        tol = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}.get(ctype, 0.0)
        np.testing.assert_allclose(cls.f64(a), cls.f64(b), rtol=tol * scale, atol=tol * scale)


def make_ctx(seed: int = 0) -> TestCtx:
    return TestCtx(seed)
'''

_FILE_HEADER = '''"""Generated by TSLGen (PyTorch port) — DO NOT EDIT.

Primitive tests in dependency (topological) order — paper §4.1.
target: {target}
"""

import warnings

import numpy as np
import torch

from {pkg} import ops, TARGET
from {pkg}._testing import make_ctx

'''

_TEST_FN = '''def test_{prim}__{test}__{short}():
    """{prim} / {test} [ctype={ctype}] deps={deps}"""
{unsafe}
    ctx = make_ctx(seed={seed})
    ctype = "{ctype}"
{body}

'''


class TestGenGPO:
    __test__ = False                    # not a pytest class, despite the name

    name = "testgen"

    def run(self, ctx: GenerationResult) -> GenerationResult:
        if ctx.errors:
            return ctx
        tested = {p for p in ctx.selection if ctx.primitives[p].tests}

        # dependency DAG over the selected primitives
        ts: graphlib.TopologicalSorter = graphlib.TopologicalSorter()
        for prim_name in sorted(ctx.selection):
            deps = {d for t in ctx.primitives[prim_name].tests for d in t.requires}
            ts.add(prim_name, *sorted(d for d in deps if d in ctx.selection))
        try:
            order = [p for p in ts.static_order() if p in tested]
        except graphlib.CycleError as e:
            ctx.fail(f"testgen: dependency cycle in test requirements: {e.args[1]}")
            return ctx

        pkg = ctx.config.package_name
        chunks = [_FILE_HEADER.format(target=ctx.config.target, pkg=pkg)]
        n_tests = 0
        for prim_name in order:
            prim = ctx.primitives[prim_name]
            sels = ctx.selection[prim_name]
            for t in prim.tests:
                unsafe_deps = [d for d in t.requires if d not in tested]
                unsafe = ""
                if unsafe_deps:
                    # paper: unsafe tests warn when executed
                    ctx.warn(f"testgen: test {prim_name}/{t.name} is UNSAFE — "
                             f"depends on untested primitives {unsafe_deps}")
                    unsafe = (f'    warnings.warn("unsafe test: depends on '
                              f'untested primitives {unsafe_deps}")\n')
                for ctype, sel in sorted(sels.items()):
                    sru = ctx.targets[sel.target].as_render_dict()
                    body = engine.render_stage1(
                        t.implementation, sru=sru, ctype=ctype,
                        primitive=prim_name, params=prim.arg_names(),
                    )
                    chunks.append(_TEST_FN.format(
                        prim=prim_name,
                        test=t.name,
                        short=engine.dtype_info(ctype)["short"],
                        ctype=ctype,
                        deps=list(t.requires),
                        unsafe=unsafe,
                        seed=n_tests,
                        body=_indent_body(body),
                    ))
                    n_tests += 1

        ctx.files.append(GeneratedFile(relpath="_testing.py",
                                       content=_TESTING_HELPERS, kind="code"))
        ctx.files.append(GeneratedFile(relpath="tests/__init__.py",
                                       content="", kind="test"))
        ctx.files.append(GeneratedFile(relpath="tests/test_generated.py",
                                       content="".join(chunks), kind="test"))
        ctx.meta["n_generated_tests"] = n_tests
        ctx.meta["test_order"] = order
        return ctx


def _indent_body(body: str) -> str:
    lines = body.splitlines() or ["pass"]
    return "\n".join("    " + ln if ln.strip() else ln for ln in lines)
