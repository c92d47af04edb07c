"""The range-count app's primitives (paper Fig 8/9/3): the port's plain
versions (repro_torch.kernels.{range_count,hadd,to_integral,softmax}.ref)
and the generated torch_cpu library against the JAX package's oracles
(repro.kernels.*.ref) and load_library("cpu_xla"), on the same seeded numpy
inputs. The Pallas ops are not compared: they cannot run under the
installed JAX (ROADMAP §3). The Hopper kernels are held against these plain
versions on the card (chip_smoke.py, tests/test_torch_cuda_kernels.py).

Tolerances: counts, int32 sums and bit words exact; hadd f32 1e-5 x the
generated tests' scale (32) relative and absolute, bf16 2e-2; softmax f32
1e-6, bf16 1e-2 (both frameworks round the same f32 statistics to bf16),
on d·softmax for rows of width d (mean 1), so the absolute term is tol/d
of a probability."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hadd import ref as jax_hadd
from repro.kernels.range_count import ref as jax_rc
from repro.kernels.softmax import ref as jax_sm
from repro.kernels.to_integral import ref as jax_ti
from repro_torch import tsl_api
from repro_torch.core import generate_all
from repro_torch.kernels.hadd import ops as hadd_ops
from repro_torch.kernels.range_count import ops as rc_ops
from repro_torch.kernels.softmax import ops as sm_ops
from repro_torch.kernels.to_integral import ops as ti_ops
from repro_torch.kernels.to_integral import ref as ti_ref

HADD_TOL = {"float32": 1e-5 * 32, "bfloat16": 2e-2}
SOFTMAX_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def port():
    return tsl_api.ops("cpu")


def _data(dtype: str, n: int, seed: int, nan: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(0, 100, n).astype(np.int32)
    x = rng.uniform(0, 100_000 if not nan else 20, n).astype(np.float32)
    if nan:
        x[::3] = np.nan
    return x


# (dtype, n, lo, hi, nan data)
RANGE_CASES = [
    ("float32", 1 << 14, 5.0, 15.0, False),
    ("float32", 1 << 14, 25000.0, 75000.0, False),
    ("float32", 1001, 2.0, 9.0, True),              # NaN is never in range
    ("int32", 4099, 5, 15, False),
    ("int32", 4099, 5.5, 7.9, False),               # fractional bounds on int32
    ("int32", 4099, 5, 7.9, False),                 # one exact, one float32 bound
    ("int32", 33, 25, 74, False),
    ("float32", 0, 1.0, 2.0, False),
]


@pytest.mark.parametrize("dtype,n,lo,hi,nan", RANGE_CASES)
def test_range_counts_match_jax(dtype, n, lo, hi, nan, port, lib_cpu):
    x = _data(dtype, n, seed=n, nan=nan)
    want = int(jax_rc.range_count(jnp.asarray(x), lo, hi))
    assert int(lib_cpu.ops.range_count(jnp.asarray(x), lo, hi)) == want
    assert int(lib_cpu.ops.range_count_popcnt(jnp.asarray(x), lo, hi)) == want
    t = torch.from_numpy(x)
    assert rc_ops.ref.range_count(t, lo, hi).dtype == torch.int32
    assert int(rc_ops.ref.range_count(t, lo, hi)) == want
    assert int(ti_ref.range_count_popcnt(t, lo, hi)) == want
    assert int(port.range_count(t, lo, hi)) == want
    assert int(port.range_count_popcnt(t, lo, hi)) == want


def test_fractional_bound_on_int32_compares_in_float32():
    """int32 arange(10) in [5.5, 7.9]: 6 and 7, as cpu_xla counts (the
    Pallas wrapper's cast of the bounds to int32 would count 5, 6, 7)."""
    x = np.arange(10, dtype=np.int32)
    assert int(jax_rc.range_count(jnp.asarray(x), 5.5, 7.9)) == 2
    assert int(rc_ops.range_count(torch.from_numpy(x), 5.5, 7.9)) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 20), (130,), (64, 512), (2, 3, 5001), (4, 1)])
def test_hadd_ref_matches_jax(shape, dtype, port, lib_cpu):
    x = np.random.default_rng(len(shape)).uniform(-2, 2, shape).astype(np.float32)
    want = np.asarray(jax_hadd.hadd(jnp.asarray(x).astype(dtype)), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = HADD_TOL[dtype]
    for got in (hadd_ops.ref.hadd(tx), port.hadd(tx)):
        assert got.dtype == tx.dtype and tuple(got.shape) == shape[:-1]
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        np.asarray(lib_cpu.ops.hadd(jnp.asarray(x).astype(dtype)), np.float32), want)


@pytest.mark.parametrize("values,n", [(3, (1 << 23) + 5),     # sum past 2^24: exact
                                      (1 << 20, 5000),        # wraps past 2^31
                                      (-7, 1001)])
def test_hadd_int32_is_exact_and_wraps_as_jnp_sum(values, n):
    x = np.full(n, values, np.int32)
    want = np.asarray(jax_hadd.hadd(jnp.asarray(x)))
    got = hadd_ops.ref.hadd(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert int(got) == int(want) == (values * n + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("shape", [(9, 11), (4, 32), (1, 1), (1025, 32), (2, 3, 31)])
def test_to_integral_ref_matches_jax(shape, port, lib_cpu):
    m = np.random.default_rng(shape[0]).random(shape) > 0.5
    want = np.asarray(jax_ti.to_integral(jnp.asarray(m)))
    assert want.dtype == np.uint32
    for got in (ti_ops.ref.to_integral(torch.from_numpy(m)),
                port.to_integral(torch.from_numpy(m))):
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(lib_cpu.ops.to_integral(jnp.asarray(m))), want)


def test_to_integral_bit_31_survives():
    m = np.zeros((3, 32), bool)
    m[0] = True
    m[1, 31] = True
    want = np.asarray([0xFFFFFFFF, 0x80000000, 0], np.uint32)
    np.testing.assert_array_equal(np.asarray(jax_ti.to_integral(jnp.asarray(m))), want)
    np.testing.assert_array_equal(ti_ops.ref.to_integral(torch.from_numpy(m)).numpy(), want)
    assert ti_ref.popcount32(ti_ops.ref.to_integral(torch.from_numpy(m))).tolist() == \
        [32, 1, 0]


def test_popcount32_matches_numpy_bit_count():
    w = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.asarray([bin(int(v)).count("1") for v in w])
    got = ti_ref.popcount32(torch.from_numpy(w.view(np.int32)).view(torch.uint32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,neg_inf", [((7, 33), False), ((4, 16), False),
                                           ((3, 9000), True), ((2, 3, 64), True)])
def test_softmax_ref_matches_jax(shape, neg_inf, dtype, port, lib_cpu):
    x = np.random.default_rng(shape[-1]).uniform(-4, 4, shape).astype(np.float32)
    if neg_inf:
        x[..., 1::7] = -np.inf
        x[0, : shape[-1] // 2] = -np.inf
    jx = jnp.asarray(x).astype(dtype)
    d = shape[-1]
    want = np.asarray(jax_sm.softmax(jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = SOFTMAX_TOL[dtype]
    for got in (sm_ops.ref.softmax(tx), port.softmax(tx)):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy() * d, want * d, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(lib_cpu.ops.softmax(jx).astype(jnp.float32)), want)


def test_softmax_row_of_only_neg_inf_is_nan_in_both():
    x = np.full((2, 8), -np.inf, np.float32)
    x[1] = np.arange(8)
    want = np.asarray(jax_sm.softmax(jnp.asarray(x)))
    got = sm_ops.ref.softmax(torch.from_numpy(x)).numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


def test_wrappers_take_the_plain_version_on_cpu_and_refuse_other_devices():
    """A CPU tensor gets the plain version and launches nothing; a tensor on
    any other device than the CPU or a card raises (no fallback)."""
    wrappers = (rc_ops.range_count, hadd_ops.hadd, ti_ops.to_integral, sm_ops.softmax)
    before = [w.launches for w in wrappers]
    x = torch.from_numpy(_data("float32", 100, 0))
    assert int(rc_ops.range_count(x, 5.0, 50000.0)) == int(rc_ops.ref.range_count(
        x, 5.0, 50000.0))
    assert torch.equal(hadd_ops.hadd(x.view(10, 10)), hadd_ops.ref.hadd(x.view(10, 10)))
    m = x.view(4, 25) > 40000
    assert torch.equal(ti_ops.to_integral(m), ti_ops.ref.to_integral(m))
    assert torch.equal(sm_ops.softmax(x.view(4, 25)), sm_ops.ref.softmax(x.view(4, 25)))
    assert [w.launches for w in wrappers] == before
    meta = torch.empty(64, device="meta")
    for call in (lambda: rc_ops.range_count(meta, 0.0, 1.0), lambda: hadd_ops.hadd(meta),
                 lambda: ti_ops.to_integral(meta.view(2, 32) > 0),
                 lambda: sm_ops.softmax(meta)):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


def test_load_set_set1_create_their_tensors_on_the_targets_device():
    """The h100 bodies of load / set / set1 name the card (cross-generated
    here, never run); the torch_cpu bodies keep the host, and run."""
    pkgs = generate_all(("torch_cpu", "h100"))
    for target, device in (("h100", "cuda"), ("torch_cpu", "cpu")):
        src = (pkgs[target] / "ops_memory.py").read_text()
        for prim in ("load", "set", "set1"):
            body = src[src.index(f"def _{prim}__"):]
            body = body[:body.index("\n\n")]
            assert f'device="{device}"' in body, (target, prim, body)
        assert f'device = "{device}"' in (pkgs[target] / "_target.py").read_text()
    ops = tsl_api.ops("cpu")
    for t in (ops.load(np.ones(3, np.float32)), ops.set([1, 2], dtype="int32"),
              ops.set1(2, (2, 2), dtype=torch.bfloat16)):
        assert t.device.type == "cpu"
    assert ops.set1(2, (2, 2), dtype=torch.bfloat16).dtype == torch.bfloat16


def test_a_target_must_name_its_device():
    """``device`` has no default: a card target that left it out would
    render load / set / set1 onto the host, so the schema refuses it."""
    import yaml

    from repro_torch.core import schema
    from repro_torch.core.loader import DEFAULT_UPD_ROOT

    raw = yaml.safe_load((DEFAULT_UPD_ROOT / "targets" / "h100.yaml").read_text())
    _, errs, _ = schema.TARGET_SCHEMA.apply(raw)
    assert errs == []
    del raw["device"]
    _, errs, _ = schema.TARGET_SCHEMA.apply(raw)
    assert any("device" in e for e in errs), errs
    _, errs, _ = schema.TARGET_SCHEMA.apply({**raw, "device": "tpu"})
    assert any("device" in e for e in errs), errs
