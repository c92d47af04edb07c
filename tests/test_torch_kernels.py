"""The port's plain kernel versions (repro_torch.kernels.*.ref) against the
JAX package's oracles (repro.kernels.*.ref) on the same seeded numpy inputs.

All comparisons in f32. Tolerance: 1e-5 absolute + 1e-5 relative — the two
frameworks sum in different orders and use different exp/rsqrt, so results
agree to a few f32 ulps, never bit for bit. The Hopper kernels themselves
are held against these plain versions on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jax_fa
from repro.kernels.rmsnorm import ref as jax_rmsnorm
from repro.kernels.swiglu import ref as jax_swiglu
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.swiglu import ops as swiglu_ops

ATOL = RTOL = 1e-5


def _rand(rng, *shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(6, 32), (2, 3, 64), (1, 1024)])
def test_rmsnorm_ref_matches_jax(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape), _rand(rng, shape[-1], lo=-1, hi=1)
    want = jax_rmsnorm.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    _close(rmsnorm_ops.ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)), want)


@pytest.mark.parametrize("shape", [(5, 24), (2, 3, 2816)])
def test_swiglu_ref_matches_jax(shape):
    rng = np.random.default_rng(1)
    g, u = _rand(rng, *shape, lo=-4, hi=4), _rand(rng, *shape)
    want = jax_swiglu.swiglu(jnp.asarray(g), jnp.asarray(u))
    _close(swiglu_ops.ref.swiglu(torch.from_numpy(g), torch.from_numpy(u)), want)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing (its counter stays put)."""
    rng = np.random.default_rng(2)
    x, w = torch.from_numpy(_rand(rng, 4, 64)), torch.from_numpy(_rand(rng, 64))
    q = torch.from_numpy(_rand(rng, 1, 4, 8, 64))
    k = torch.from_numpy(_rand(rng, 1, 2, 8, 64))
    before = (rmsnorm_ops.rmsnorm.launches, swiglu_ops.swiglu.launches,
              fa_ops.flash_attention.launches)
    assert torch.equal(rmsnorm_ops.rmsnorm(x, w), rmsnorm_ops.ref.rmsnorm(x, w))
    assert torch.equal(swiglu_ops.swiglu(x, x), swiglu_ops.ref.swiglu(x, x))
    assert torch.equal(fa_ops.flash_attention(q, k, k), fa.attention(q, k, k))
    assert before == (rmsnorm_ops.rmsnorm.launches, swiglu_ops.swiglu.launches,
                      fa_ops.flash_attention.launches)


# (B, H, KH, Sq, Sk, D, causal, kv_len)
FLASH_CASES = [
    pytest.param(2, 4, 4, 16, 16, 8, True, None, id="causal"),
    pytest.param(2, 4, 4, 16, 16, 8, False, None, id="non_causal"),
    pytest.param(1, 4, 2, 24, 24, 16, True, None, id="gqa_causal"),
    pytest.param(1, 4, 2, 8, 8, 16, False, None, id="gqa_non_causal"),
    pytest.param(2, 4, 2, 6, 20, 8, True, 13, id="kv_len_below_sk"),
    pytest.param(1, 4, 2, 12, 12, 8, True, 5, id="sq_above_kv_len_masked_rows"),
    pytest.param(2, 4, 2, 1, 20, 8, True, 9, id="sq_one"),
]


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,kv_len", FLASH_CASES)
def test_flash_attention_ref_matches_jax(b, h, kh, sq, sk, d, causal, kv_len):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, b, h, sq, d), _rand(rng, b, kh, sk, d), _rand(rng, b, kh, sk, d)
    want = jax_fa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, kv_len=kv_len)
    got = fa.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       causal=causal, kv_len=kv_len)
    _close(got, want)
    if kv_len is not None and sq > kv_len:
        # rows that see no key at all output exactly 0 (the kernel contract)
        dead = sq - kv_len
        assert torch.count_nonzero(got[:, :, :dead]) == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [4, 256])
def test_attention_chunked_matches_jax_per_slot_kv_len(causal, block_k):
    rng = np.random.default_rng(4)
    b, h, kh, c, s, d = 3, 4, 2, 5, 18, 8
    q, k, v = _rand(rng, b, h, c, d), _rand(rng, b, kh, s, d), _rand(rng, b, kh, s, d)
    kv_len = np.asarray([5, 11, 18], np.int32)          # a (B,) vector of fills
    want = jax_fa.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, kv_len=jnp.asarray(kv_len),
                                    block_k=block_k)
    got = fa.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               kv_len=torch.from_numpy(kv_len), block_k=block_k)
    _close(got, want)


@pytest.mark.parametrize("kv_len", [None, 7, "vector"])
def test_attention_decode_matches_jax(kv_len):
    rng = np.random.default_rng(5)
    b, h, kh, s, d = 3, 8, 2, 16, 8
    q, k, v = _rand(rng, b, h, 1, d), _rand(rng, b, kh, s, d), _rand(rng, b, kh, s, d)
    if kv_len == "vector":
        kv_len = np.asarray([1, 9, 16], np.int32)
        jkv, tkv = jnp.asarray(kv_len), torch.from_numpy(kv_len)
    else:
        jkv = tkv = kv_len
    want = jax_fa.attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   kv_len=jkv)
    got = fa.attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), kv_len=tkv)
    _close(got, want)
