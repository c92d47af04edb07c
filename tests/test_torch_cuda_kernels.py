"""The Hopper kernels against their plain versions on the card. These run
only on an sm_90 card (marker ``cuda``) and skip elsewhere with the reason;
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The paged cases draw their tables as permutations of the pool with the
scratch page (0) padding each row past its coverage.

Tolerance: bf16 |kernel - plain| <= 1e-2 + 1e-2 |plain| (one bf16 rounding
step where f32 sums round differently); f32 1e-4 + 1e-4 |plain|."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged import ops as pa
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


def _paged_operands(dev, dtype, b, h, kh, d, page, sq, kv_lens, width, seed=0):
    """q, pools and tables for one paged case: every sequence's pages are a
    slice of one permutation of the pool (page 0 is the scratch page and pads
    each table row past its coverage); q, k and v come from one generator."""
    rand = _draws(dev, dtype, seed)
    used = [-(-n // page) for n in kv_lens]
    n_pages = 1 + sum(used) + 2
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))
            + 1).tolist()
    tables = torch.zeros(b, width, dtype=torch.int32)
    for i, u in enumerate(used):
        tables[i, :u] = torch.tensor(perm[:u], dtype=torch.int32)
        perm = perm[u:]
    q = rand(b, h, sq, d)
    k, v = rand(kh, n_pages, page, d), rand(kh, n_pages, page, d)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return q, k, v, tables.to(dev), kv_len


# (B, H, KH, D, page, SQ, kv_len per sequence, table width, block_k)
PAGED_CASES = [
    # the serving path: batch 8, 16 heads, page 64; kv_len 0, 1, partial pages
    # and a full 5-entry table
    (8, 16, 16, 64, 64, 1, [0, 1, 100, 320, 257, 64, 63, 200], 5, 64),
    # GQA (group 5) with a 4-row span: rows before the first key output 0
    (3, 40, 8, 128, 16, 4, [2, 37, 64], 4, 64),
    # pages larger than a tile: 256-row pages walked in 64-row tiles
    (2, 8, 2, 128, 256, 1, [300, 511], 2, 64),
    # block_k 16 on 64-row pages
    (2, 4, 4, 64, 64, 3, [130, 5], 3, 16),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kh,d,page,sq,kv_lens,width,block_k", PAGED_CASES)
def test_paged_attention_kernel(dev, b, h, kh, d, page, sq, kv_lens, width, block_k,
                                dtype):
    q, k, v, tables, kv_len = _paged_operands(dev, dtype, b, h, kh, d, page, sq,
                                              kv_lens, width)
    assert not torch.equal(k, v)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, kv_len, block_k=block_k)
    assert pa.paged_attention.launches == before + 1
    _check(got, pa.ref.paged_attention_ref(q, k, v, tables, kv_len), dtype)
    for i, n in enumerate(kv_lens):
        if n < sq:      # span rows before the first key see nothing: exactly 0
            rows = got[i].reshape(kh, h // kh, sq, d)[:, :, :sq - n]
            assert torch.count_nonzero(rows) == 0


def test_paged_attention_rejects_what_it_does_not_take(dev):
    q, k, v, tables, kv_len = _paged_operands(dev, torch.bfloat16, 2, 4, 4, 64, 16, 1,
                                              [5, 9], 2)
    with pytest.raises(NotImplementedError, match="int8"):
        pa.paged_attention(q, k, v, tables, kv_len, k_scale=k, v_scale=v)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_attention(q, k, v, tables.long(), kv_len)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, k.float(), v.float(), tables, kv_len)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), tables, kv_len)
