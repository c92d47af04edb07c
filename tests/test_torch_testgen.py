"""The port's test-generation GPO (paper §4.1; mirrors
tests/test_testgen_buildgen.py and tests/test_generated_suite.py): the
dependency DAG, topological order, UNSAFE warnings, the generated torch_cpu
suite run in full, and its test functions against the reference's cpu_xla
suite, one per (primitive, test, ctype) for the primitives both carry."""

import importlib
import json
import re
import warnings
from pathlib import Path

import pytest

from repro_torch.core import GenConfig, generate_library, load_library
from repro_torch.core.model import (CorpusIR, GenerationResult, ImplDef, ParamDef,
                                    PrimitiveDef, TargetDef, TestDef)
from repro_torch.core.select import SelectGPO
from repro_torch.core.testgen import TestGenGPO

# reference tests of primitives the port carries that need what the port
# has not ported: none
NOT_PORTED: set[str] = set()
# tests the port adds for its kernels' paths (the card's split rows, wide
# softmax rows, bit 31, float32 promotion of a fractional bound) and the moe
# family's (planted router ties, the float32 expert blocks, the bf16 expert
# FFN through the swiglu kernel: the reference's expert_ffn is float32 only)
PORT_ONLY = {"test_hadd__long_rows", "test_softmax__wide_rows_with_neg_inf",
             "test_to_integral__bit_31_survives", "test_range_count__fractional_bounds",
             "test_topk_gating__ties_lower_index_first", "test_expert_ffn__blocks_of_experts",
             "test_expert_ffn__matches_numpy"}


def _target():
    return TargetDef(
        name="t", vendor="v", flags=("torch",), ctypes=("float32",),
        default_ctype="float32", lanes=32, sublanes=4, mxu=(64, 256),
        vmem_bytes=1, hbm_bytes=1, peak_flops_bf16=1.0, hbm_bw=1.0,
        ici_bw=1.0, ici_links=1, device="cpu")


def _prim(name, requires=(), tested=True):
    tests = (TestDef(name="t1", implementation="assert True",
                     requires=tuple(requires)),) if tested else ()
    return PrimitiveDef(
        name=name, group="g", brief="", parameters=(ParamDef("a"),),
        returns_ctype="register",
        definitions=(ImplDef(target_extension="t", ctypes=("float32",),
                             flags=("torch",), implementation="return a"),),
        tests=tests)


def _ctx(prims):
    corpus = CorpusIR.from_defs(targets={"t": _target()},
                                primitives={p.name: p for p in prims})
    ctx = GenerationResult(config=GenConfig(target="t", package_name="pkg"), corpus=corpus)
    SelectGPO().run(ctx)
    return ctx


def _generated(ctx) -> str:
    return next(f for f in ctx.files if f.relpath == "tests/test_generated.py").content


def test_topological_order():
    ctx = _ctx([_prim("c", requires=("b",)), _prim("b", requires=("a",)), _prim("a")])
    TestGenGPO().run(ctx)
    order = ctx.meta["test_order"]
    assert order.index("a") < order.index("b") < order.index("c")
    src = _generated(ctx)
    assert src.index("test_a__t1") < src.index("test_b__t1") < src.index("test_c__t1")


def test_cycle_detected():
    ctx = _ctx([_prim("a", requires=("b",)), _prim("b", requires=("a",))])
    TestGenGPO().run(ctx)
    assert any("cycle" in e for e in ctx.errors)


def test_unsafe_marking_warns_at_generation_and_when_run():
    """Paper §4.1: a test that depends on an untested primitive is UNSAFE:
    a generation warning, and a runtime warning when it executes."""
    ctx = _ctx([_prim("a", tested=False), _prim("b", requires=("a",)),
                _prim("c", requires=("b",))])
    TestGenGPO().run(ctx)
    unsafe = [w for w in ctx.warnings if "UNSAFE" in w]
    assert len(unsafe) == 1 and "b/t1" in unsafe[0] and "['a']" in unsafe[0]
    src = _generated(ctx)
    b_fn = src[src.index("def test_b__t1"):src.index("def test_c__t1")]
    assert 'warnings.warn("unsafe test: depends on untested primitives [\'a\']")' in b_fn
    assert "unsafe" not in src[src.index("def test_c__t1"):]


@pytest.fixture(scope="module")
def torch_cpu_suite():
    lib = load_library("torch_cpu")
    mod = importlib.import_module(lib.__name__ + ".tests.test_generated")
    return lib, mod, [n for n in vars(mod) if n.startswith("test_")]


def test_generated_torch_cpu_suite_passes_in_full(torch_cpu_suite):
    _, mod, names = torch_cpu_suite
    assert len(names) > 90
    failures = []
    for name in names:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")      # no test of the corpus is UNSAFE
                getattr(mod, name)()
        except Exception as e:  # noqa: BLE001 - collected, reported together
            failures.append(f"{name}: {type(e).__name__}: {e}")
    assert not failures, "\n".join(failures[:10])


def test_generated_order_respects_the_requires_dag(torch_cpu_suite):
    lib, _, _ = torch_cpu_suite
    src = (Path(lib.__file__).parent / "tests" / "test_generated.py").read_text()
    order, deps = [], {}
    for m in re.finditer(r"def test_(\w+?)__(\w+?)__(\w+)\(\):\n    \"\"\".*?deps=\[(.*?)\]",
                         src, re.S):
        prim = m.group(1)
        if prim not in order:
            order.append(prim)
        deps.setdefault(prim, set()).update(
            s.strip("' ") for s in m.group(4).split(",") if s.strip())
    assert len(order) == len(lib.PRIMITIVES)        # every primitive has tests
    pos = {p: i for i, p in enumerate(order)}
    for prim, reqs in deps.items():
        for r in reqs:
            assert pos[r] < pos[prim], (r, prim)


def test_one_test_per_primitive_test_and_ctype_as_the_reference(torch_cpu_suite, lib_cpu):
    _, mod, names = torch_cpu_suite
    ref = importlib.import_module(lib_cpu.__name__ + ".tests.test_generated")
    ref_names = {n for n in vars(ref) if n.startswith("test_")}
    shared = set(load_library("torch_cpu").PRIMITIVES) & set(lib_cpu.PRIMITIVES)

    def carried(n):
        return any(n.startswith(f"test_{p}__") for p in shared)

    assert len(names) == len(set(names))
    port = {n for n in names if carried(n)}
    ref_shared = {n for n in ref_names if carried(n)}
    assert {n.rsplit("__", 1)[0] for n in ref_shared - port} == NOT_PORTED
    assert {n.rsplit("__", 1)[0] for n in port - ref_shared} == PORT_ONLY


def test_manifest_records_selection_provenance(torch_cpu_suite):
    lib, _, names = torch_cpu_suite
    pkg = Path(lib.__file__).parent
    man = json.loads((pkg / "_manifest.json").read_text())
    assert man["target"] == "torch_cpu" and man["n_generated_tests"] == len(names)
    popcnt = man["primitives"]["range_count_popcnt"]["float32"]
    assert popcnt["required_flags"] == ["torch", "popcnt"] and popcnt["candidates"] == 2
    assert man["primitives"]["to_integral"]["float32"]["is_native"] is False
    for f in man["files"]:
        assert (pkg / f).is_file(), f


def test_h100_cross_generation_emits_its_suite_for_the_card(tmp_path):
    pkg, result = generate_library(GenConfig(target="h100"), tmp_path)
    man = json.loads((pkg / "_manifest.json").read_text())
    assert man["primitives"]["to_integral"]["float32"]["is_native"] is True
    assert man["primitives"]["range_count_popcnt"]["int32"]["required_flags"][-2:] == \
        ["ballot", "popcnt"]
    src = (pkg / "tests" / "test_generated.py").read_text()
    assert src.count("\ndef test_") == result.meta["n_generated_tests"] > 90
    assert "from repro_torch.kernels.flash_attention import ref" in src
    compile(src, "test_generated.py", "exec")
    assert "device: str = TARGET.device" in (pkg / "_testing.py").read_text()


def test_emit_tests_false_generates_no_suite(tmp_path):
    pkg, _ = generate_library(GenConfig(target="torch_cpu", emit_tests=False), tmp_path)
    assert not (pkg / "tests").exists() and not (pkg / "_testing.py").exists()
    with_tests, _ = generate_library(GenConfig(target="torch_cpu"), tmp_path)
    assert with_tests != pkg and (with_tests / "tests" / "test_generated.py").is_file()
