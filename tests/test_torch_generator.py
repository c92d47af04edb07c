"""The port's generator: its UPD corpus, selection per target, the generated
torch library against the JAX package's ``cpu_xla`` library, dtype dispatch
and the cost channel.

``h100`` is only cross-generated here (rendered and stored, never executed:
this host has no card). The ``torch_cpu`` library is executed and compared
with ``load_library("cpu_xla")`` primitive by primitive on the same seeded
numpy inputs, in f32, within 1e-5 absolute + 1e-5 relative (different
summation orders, never bit-for-bit)."""

import ast
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tsl_api as jax_tsl_api
from repro.serve import upd_serve_defaults as jax_serve_defaults
from repro_torch import tsl_api
from repro_torch.core import GenConfig, generate_all, load_corpus, load_library
from repro_torch.core.pipeline import core_pipeline
from repro_torch.serve import upd_serve_defaults

SLICE_PRIMITIVES = ("load", "set1", "embed_lookup", "cache_update", "matmul", "rmsnorm",
                    "layernorm", "rope_apply", "swiglu", "flash_attention",
                    "attention_prefill_chunk", "attention_decode", "cache_page_read",
                    "cache_page_write", "attention_decode_paged",
                    # the range-count app (Fig 8) and the suite's softmax
                    "set", "select", "between_inclusive", "hadd", "to_integral",
                    "range_count", "range_count_popcnt", "softmax",
                    # training: the loss and the attention backward
                    "cross_entropy", "flash_attention_bwd",
                    # speculative decoding: the verify span, lane and paged
                    "attention_verify", "attention_verify_paged",
                    # the rwkv family
                    "token_shift", "wkv6_scan", "wkv6_decode", "silu", "sigmoid",
                    # the zamba family
                    "causal_conv1d", "ssd_scan", "ssd_chunked", "ssd_decode",
                    # the whisper family
                    "gelu",
                    # the moe family
                    "topk_gating", "moe_dispatch", "moe_combine", "expert_ffn")
KERNEL_MODULES = {"rmsnorm": "repro_torch.kernels.rmsnorm.ops",
                  "swiglu": "repro_torch.kernels.swiglu.ops",
                  "flash_attention": "repro_torch.kernels.flash_attention.ops",
                  "flash_attention_bwd": "repro_torch.kernels.flash_attention.ops",
                  "attention_decode_paged": "repro_torch.kernels.paged.ops",
                  "attention_verify_paged": "repro_torch.kernels.paged.ops",
                  "range_count": "repro_torch.kernels.range_count.ops",
                  "hadd": "repro_torch.kernels.hadd.ops",
                  "to_integral": "repro_torch.kernels.to_integral.ops",
                  "softmax": "repro_torch.kernels.softmax.ops"}
ATOL = RTOL = 1e-5


def _selection(target):
    cfg = GenConfig(target=target)
    return core_pipeline(cfg).run(cfg, corpus=load_corpus())


def test_corpus_covers_the_slice_on_both_targets():
    corpus = load_corpus()
    assert set(corpus.targets) == {"torch_cpu", "h100"}
    assert set(corpus.primitives) == set(SLICE_PRIMITIVES)
    for target in corpus.targets:
        assert set(_selection(target).selection) == set(SLICE_PRIMITIVES)


@pytest.mark.parametrize("prim", sorted(KERNEL_MODULES))
def test_h100_selects_the_kernel_torch_cpu_the_plain_version(prim):
    h100 = _selection("h100").selection[prim]
    cpu = _selection("torch_cpu").selection[prim]
    assert set(h100) == set(cpu) and "float32" in h100
    for ctype in h100:
        assert KERNEL_MODULES[prim] in h100[ctype].impl.helpers
        assert h100[ctype].impl.target_extension == "h100"
        assert "cuda" in h100[ctype].impl.flags
        assert "ref" in cpu[ctype].impl.helpers
        assert ".ops import" not in cpu[ctype].impl.helpers
        assert "cuda" not in cpu[ctype].impl.flags


def test_cross_generation_writes_both_packages_that_parse():
    out = generate_all()
    assert set(out) == {"torch_cpu", "h100"}
    h100 = out["h100"]
    for f in h100.glob("*.py"):
        ast.parse(f.read_text())
    ops_src = "".join(f.read_text() for f in sorted(h100.glob("ops_*.py")))
    for mod in KERNEL_MODULES.values():
        assert f"from {mod} import" in ops_src
    target_src = (h100 / "_target.py").read_text()
    assert 'torch.bfloat16: "bfloat16"' in target_src
    assert "peak_flops_bf16 = 989000000000000.0" in target_src
    assert "hbm_bw = 3350000000000.0" in target_src


def test_bf16_dispatches_to_the_bf16_specialisation(tmp_path):
    """A primitive whose body renders differently per ctype gets one
    specialisation each; a bf16 tensor must reach the bf16 one through the
    explicit torch-dtype -> ctype map (str(torch.bfloat16) is
    "torch.bfloat16", which a str-keyed table would miss)."""
    upd = tmp_path / "upd"
    (upd / "primitives").mkdir(parents=True)
    (upd / "primitives" / "probe.yaml").write_text(textwrap.dedent("""\
        ---
        primitive_name: "ctype_probe"
        group: "probe"
        parameters:
          - {name: "x", ctype: "register"}
        definitions:
          - target_extension: ["torch_cpu", "h100"]
            ctype: ["float32", "bfloat16"]
            lscpu_flags: ["torch"]
            implementation: |
              return "{{ ctype }}", {{ dtype.torch }}
        ...
        """))
    lib = load_library("torch_cpu", upd_paths=(str(upd),),
                       build_root=tmp_path / "build")
    assert lib.ops.ctype_probe(torch.zeros(2, dtype=torch.bfloat16)) == \
        ("bfloat16", torch.bfloat16)
    assert lib.ops.ctype_probe(torch.zeros(2)) == ("float32", torch.float32)


def test_upd_roots_are_the_package_corpus_plus_upd_paths(tmp_path, monkeypatch):
    """Extra UPD roots come only through ``upd_paths``: a corpus named in the
    environment (under the port's or the reference's variable name) adds no
    primitive and leaves the fingerprint as it was."""
    from repro_torch.core import loader

    upd = tmp_path / "upd"
    (upd / "primitives").mkdir(parents=True)
    (upd / "primitives" / "extra.yaml").write_text(
        '---\nprimitive_name: "env_extra"\ndefinitions: []\n...\n')
    names = {d["primitive_name"] for d in loader.load_raw_primitives()}
    fingerprint = loader.upd_fingerprint()
    for var in ("REPRO_TORCH_TSL_UPD_PATH", "REPRO_TSL_UPD_PATH"):
        monkeypatch.setenv(var, str(upd))
    assert {d["primitive_name"] for d in loader.load_raw_primitives()} == names
    assert loader.upd_fingerprint() == fingerprint
    assert "env_extra" in {d["primitive_name"]
                           for d in loader.load_raw_primitives((str(upd),))}
    assert loader.upd_fingerprint((str(upd),)) != fingerprint


@pytest.fixture(scope="module")
def libs(lib_cpu):
    return tsl_api.ops("cpu"), lib_cpu.ops


def _rand(rng, *shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _args(prim, rng):
    """(positional numpy args, kwargs) for one call of ``prim``."""
    if prim == "load":
        return (_rand(rng, 4, 8),), {}
    if prim == "set1":
        return (3, (4, 8)), {"dtype": "float32"}
    if prim == "embed_lookup":
        return (_rand(rng, 11, 6), np.asarray([[0, 3], [10, 7]], np.int32)), {}
    if prim == "cache_update":
        return (_rand(rng, 2, 6, 3, 4), _rand(rng, 2, 2, 3, 4), 3), {}
    if prim == "matmul":
        return (_rand(rng, 2, 5, 7), _rand(rng, 7, 3)), {}
    if prim == "rmsnorm":
        return (_rand(rng, 6, 32), _rand(rng, 32)), {"eps": 1e-6}
    if prim == "layernorm":
        return (_rand(rng, 5, 48), _rand(rng, 48), _rand(rng, 48)), {}
    if prim == "rope_apply":
        ang = rng.uniform(0, 3, (5, 1, 4)).astype(np.float32)
        return (_rand(rng, 2, 5, 3, 8), np.cos(ang), np.sin(ang)), {}
    if prim == "swiglu":
        return (_rand(rng, 5, 24, lo=-4, hi=4), _rand(rng, 5, 24)), {}
    if prim == "flash_attention":
        return (_rand(rng, 1, 4, 10, 8), _rand(rng, 1, 2, 12, 8),
                _rand(rng, 1, 2, 12, 8)), {"causal": True, "kv_len": 10}
    if prim == "attention_prefill_chunk":
        return (_rand(rng, 1, 4, 4, 8), _rand(rng, 1, 2, 12, 8),
                _rand(rng, 1, 2, 12, 8)), {"kv_len": 10}
    if prim == "attention_decode":
        return (_rand(rng, 1, 4, 1, 8), _rand(rng, 1, 2, 9, 8),
                _rand(rng, 1, 2, 9, 8)), {"kv_len": 7}
    if prim == "cache_page_read":
        return (_rand(rng, 512, 3), np.asarray([256, 0, 128], np.int32)), {}
    if prim == "cache_page_write":
        return (_rand(rng, 512, 3), _rand(rng, 3 * 64, 3),
                np.asarray([256, 0, 128], np.int32)), {}
    if prim == "set":
        return ([1, 2, 3, 4],), {"dtype": "float32"}
    if prim == "select":
        return (rng.random((4, 8)) > 0.5, _rand(rng, 4, 8), _rand(rng, 4, 8)), {}
    if prim == "between_inclusive":
        return (_rand(rng, 64, lo=0, hi=20), np.full(64, 5, np.float32),
                np.full(64, 15, np.float32)), {}
    if prim == "hadd":
        return (_rand(rng, 3, 20),), {}
    if prim == "to_integral":
        return (rng.random((9, 32)) > 0.5,), {}
    if prim in ("range_count", "range_count_popcnt"):
        return (_rand(rng, 517, lo=0, hi=100), 10.0, 40.0), {}
    if prim == "softmax":
        return (_rand(rng, 4, 16, lo=-4, hi=4),), {}
    if prim == "attention_decode_paged":
        tables = np.asarray([[3, 1, 0], [2, 4, 5]], np.int32)
        return (_rand(rng, 2, 4, 1, 8), _rand(rng, 2, 6, 8, 8), _rand(rng, 2, 6, 8, 8),
                tables), {"kv_len": np.asarray([13, 24], np.int32)}
    if prim == "attention_verify":
        return (_rand(rng, 2, 4, 3, 8), _rand(rng, 2, 2, 12, 8),
                _rand(rng, 2, 2, 12, 8)), {"kv_len": np.asarray([10, 5], np.int32)}
    if prim == "attention_verify_paged":
        tables = np.asarray([[3, 1, 0], [2, 4, 5]], np.int32)
        return (_rand(rng, 2, 4, 3, 8), _rand(rng, 2, 6, 8, 8), _rand(rng, 2, 6, 8, 8),
                tables), {"kv_len": np.asarray([13, 24], np.int32)}
    if prim == "cross_entropy":
        return (_rand(rng, 2, 5, 40, lo=-3, hi=3),
                rng.integers(0, 40, (2, 5)).astype(np.int32)), {}
    if prim == "flash_attention_bwd":
        return (_rand(rng, 1, 4, 9, 8), _rand(rng, 1, 2, 9, 8), _rand(rng, 1, 2, 9, 8),
                _rand(rng, 1, 4, 9, 8)), {"causal": True}
    if prim == "token_shift":
        return (_rand(rng, 2, 5, 6), _rand(rng, 6, lo=0, hi=1)), {}
    if prim in ("silu", "sigmoid", "gelu"):
        return (_rand(rng, 6, 19, lo=-4, hi=4),), {}
    if prim in ("wkv6_scan", "wkv6_decode"):
        lead = (2, 9) if prim == "wkv6_scan" else (2,)
        r, k, v = (_rand(rng, *lead, 3, 8, lo=-1, hi=1) for _ in range(3))
        w = rng.uniform(0.7, 0.999, (*lead, 3, 8)).astype(np.float32)
        extra = (_rand(rng, 2, 3, 8, 8),) if prim == "wkv6_decode" else ()
        return (r, k, v, w, _rand(rng, 3, 8, lo=-1, hi=1), *extra), {}
    if prim == "causal_conv1d":
        return (_rand(rng, 2, 9, 6), _rand(rng, 4, 6, lo=-1, hi=1)), {}
    if prim == "topk_gating":
        return (_rand(rng, 12, 8, lo=-3, hi=3),), {"k": 2}
    if prim == "moe_dispatch":
        idx = rng.integers(0, 4, (12, 2)).astype(np.int32)
        return (_rand(rng, 12, 6), idx, _rand(rng, 12, 2, lo=0, hi=1)), \
            {"n_experts": 4, "capacity": 5}
    if prim == "moe_combine":
        flat_e = rng.integers(0, 4, 24).astype(np.int32)
        slot = rng.integers(0, 5, 24).astype(np.int32)
        info = (flat_e, slot, rng.random(24) > 0.3, _rand(rng, 24, lo=0, hi=1), 12)
        return (_rand(rng, 4, 5, 6), info), {}
    if prim == "expert_ffn":
        return (_rand(rng, 3, 5, 6, lo=-1, hi=1), _rand(rng, 3, 6, 7, lo=-1, hi=1),
                _rand(rng, 3, 6, 7, lo=-1, hi=1), _rand(rng, 3, 7, 6, lo=-1, hi=1)), {}
    if prim in ("ssd_scan", "ssd_chunked", "ssd_decode"):
        lead = (2,) if prim == "ssd_decode" else (2, 9)
        x = _rand(rng, *lead, 3, 4, lo=-1, hi=1)
        a = rng.uniform(0.8, 0.999, (*lead, 3)).astype(np.float32)
        b, c = (_rand(rng, *lead, 5, lo=-1, hi=1) for _ in range(2))
        if prim == "ssd_decode":
            return (x, a, b, c, _rand(rng, 2, 3, 4, 5)), {}
        return (x, a, b, c), ({"chunk": 4} if prim == "ssd_chunked" else {})
    raise KeyError(prim)


def _leaves(x):
    """The arrays of a result, nested tuples flattened (moe_dispatch's info),
    in order; a Python int (the info's token count) as an array."""
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def _convert(a, fn):
    """numpy arrays through ``fn``, nested tuples (moe_combine's info) too."""
    if isinstance(a, tuple):
        return tuple(_convert(x, fn) for x in a)
    return fn(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("prim", SLICE_PRIMITIVES)
def test_torch_cpu_library_matches_cpu_xla(prim, libs):
    port, ref = libs
    args, kwargs = _args(prim, np.random.default_rng(7))
    want = getattr(ref, prim)(*[_convert(a, jnp.asarray) for a in args], **kwargs)
    got = getattr(port, prim)(*[_convert(a, lambda x: torch.from_numpy(x.copy()))
                                for a in args], **kwargs)
    # flash_attention_bwd, wkv6_*, ssd_*, topk_gating, moe_dispatch: tuples
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prim,term,shapes", [
    ("attention_decode", "bytes", dict(B=8, H=16, KH=16, S=320, D=64, TP=1)),
    ("attention_decode", "flops", dict(B=8, H=16, KH=16, S=320, D=64, TP=1)),
    ("attention_prefill_chunk", "flops", dict(B=1, H=16, KH=16, C=64, S=256, D=64, TP=1)),
    ("attention_prefill_chunk", "bytes", dict(B=1, H=16, KH=16, C=64, S=256, D=64, TP=1)),
    ("attention_prefill_chunk", "comms", dict(B=1, H=16, KH=16, C=64, S=256, D=64, TP=4)),
    ("attention_decode_paged", "bytes", dict(B=8, H=16, KH=16, P=5, PAGE=64, D=64)),
    ("attention_decode_paged", "flops", dict(B=8, H=16, KH=16, P=5, PAGE=64, D=64)),
    ("attention_verify", "bytes", dict(B=8, H=16, KH=16, SV=5, S=320, D=64, TP=1)),
    ("attention_verify", "flops", dict(B=8, H=16, KH=16, SV=5, S=320, D=64, TP=1)),
    ("attention_verify", "comms", dict(B=8, H=16, KH=16, SV=5, S=320, D=64, TP=4)),
    ("attention_verify_paged", "bytes", dict(B=8, H=16, KH=16, SV=5, P=5, PAGE=64, D=64)),
    ("attention_verify_paged", "flops", dict(B=8, H=16, KH=16, SV=5, P=5, PAGE=64, D=64)),
    ("cache_page_read", "bytes", dict(N=4, PAGE=64, R=24576)),
    ("cache_page_write", "bytes", dict(N=4, PAGE=64, R=24576)),
])
def test_cost_channel_matches_the_reference(prim, term, shapes, lib_cpu):
    want = jax_tsl_api.cost(prim, term, **shapes)
    assert tsl_api.cost(prim, term, device="cpu", **shapes) == want
    # h100 prices from the same formulas (read from its selection, not run)
    h100 = _selection("h100").selection[prim]["bfloat16"].impl.cost
    assert h100 == _selection("torch_cpu").selection[prim]["bfloat16"].impl.cost


def test_serve_block_matches_the_reference():
    assert upd_serve_defaults() == jax_serve_defaults()
