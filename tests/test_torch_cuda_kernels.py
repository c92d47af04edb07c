"""The Hopper kernels against their plain versions on the card. These run
only on an sm_90 card (marker ``cuda``) and skip elsewhere with the reason;
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance: bf16 |kernel - plain| <= 1e-2 + 1e-2 |plain| (one bf16 rounding
step where f32 sums round differently); f32 1e-4 + 1e-4 |plain|."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.swiglu import ops as sw

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    from repro_torch.device import is_hopper

    if not is_hopper():
        pytest.skip("needs an sm_90 (Hopper) CUDA card")
    return torch.device("cuda")


def _draws(dev, dtype, seed=0):
    """One generator per test: each call draws the next, different tensor."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g, device=dev).to(dtype)


def _check(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1024), (8, 1024), (3, 5, 1000), (4096, 1024)])
def test_rmsnorm_kernel(dev, shape, dtype):
    rand = _draws(dev, dtype)
    x, w = rand(*shape), rand(shape[-1])
    before = rn.rmsnorm.launches
    _check(rn.rmsnorm(x, w), rn.ref.rmsnorm(x, w), dtype)
    assert rn.rmsnorm.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 2816), (3, 1001), (4096, 2816)])
def test_swiglu_kernel(dev, shape, dtype):
    rand = _draws(dev, dtype)
    g, u = rand(*shape), rand(*shape)
    assert not torch.equal(g, u)
    before = sw.swiglu.launches
    _check(sw.swiglu(g, u), sw.ref.swiglu(g, u), dtype)
    assert sw.swiglu.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,kv_len", [
    (2, 16, 16, 512, 512, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, None),         # GQA
    (2, 4, 2, 100, 100, 64, False, None),
    (2, 16, 16, 64, 320, 64, True, 300),          # continuation, kv_len < Sk
    (1, 4, 2, 80, 80, 64, True, 30),              # Sq > kv_len: masked rows -> 0
    (3, 4, 4, 1, 77, 128, True, 50),              # Sq = 1
])
def test_flash_attention_kernel(dev, b, h, kh, sq, sk, d, causal, kv_len, dtype):
    rand = _draws(dev, dtype)
    q, k, v = rand(b, h, sq, d), rand(b, kh, sk, d), rand(b, kh, sk, d)
    assert not torch.equal(k, v)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    _check(got, fa.ref.attention(q, k, v, causal=causal, kv_len=kv_len), dtype)
    if kv_len is not None and sq > kv_len:
        assert torch.count_nonzero(got[:, :, :sq - kv_len]) == 0


def test_flash_attention_rejects_what_it_does_not_take(dev):
    rand = _draws(dev, torch.bfloat16)
    q = rand(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = rand(1, 2, 64, 8).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)
