"""The Hopper kernels against their plain versions on the card. These run
only on an sm_90 card (marker ``cuda``) and skip elsewhere with the reason;
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The paged cases draw their tables as permutations of the pool with the
scratch page (0) padding each row past its coverage.

Tolerance: bf16 |kernel - plain| <= 1e-2 + 1e-2 |plain| (one bf16 rounding
step where f32 sums round differently); f32 1e-4 + 1e-4 |plain|. Softmax
compares d·softmax on rows of width d (mean 1), so its absolute term is
1e-2/d (bf16) or 1e-4/d (f32) of a probability. Counts, int32 sums and
packed words are integers: equal, bit for bit."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.hadd import ops as ha
from repro_torch.kernels.paged import ops as pa
from repro_torch.kernels.range_count import ops as rc
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.softmax import ops as sm
from repro_torch.kernels.swiglu import ops as sw
from repro_torch.kernels.to_integral import ops as ti

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


def _check(got, want, dtype, row_width=1):
    """|got - want| <= tol + tol |want|, both multiplied by ``row_width``
    first (softmax passes d, so the absolute term is tol/d)."""
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float() * row_width, want.float() * row_width,
                               atol=tol, rtol=tol)


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


EDGE_LENGTHS = [0, 1, 31, 33, (1 << 20) + 7]


def _equal(got, want):
    torch.cuda.synchronize()
    g, w = (t.view(torch.int32) if t.dtype == torch.uint32 else t for t in (got, want))
    assert g.shape == w.shape and g.dtype == w.dtype
    assert torch.equal(g, w), (g.long() - w.long()).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("n", EDGE_LENGTHS + [1 << 24])
@pytest.mark.parametrize("lo,hi", [(10, 40), (5.5, 7.9), (5, 7.9), (-1.0, 200.0)])
def test_range_count_kernel(dev, n, dtype, lo, hi):
    g = torch.Generator(device=dev).manual_seed(n)
    data = torch.randint(0, 100, (n,), generator=g, device=dev, dtype=torch.int32).to(dtype)
    before = rc.range_count.launches
    _equal(rc.range_count(data, lo, hi), rc.ref.range_count(data, lo, hi))
    assert rc.range_count.launches == before + (n > 0)


def test_range_count_kernel_off_alignment_nan_and_shape(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(4099, generator=g, device=dev) * 20
    x[::5] = float("nan")
    for view in (x[1:], x[2:-1], x[3:], x.view(1, 4099)[:, 1:].reshape(-1)):
        _equal(rc.range_count(view, 2.0, 9.0), rc.ref.range_count(view, 2.0, 9.0))
    m = x.view(1, 4099)[:, :4096].reshape(64, 64)
    _equal(rc.range_count(m, 2.0, 9.0), rc.ref.range_count(m, 2.0, 9.0))
    with pytest.raises(TypeError, match="dtype"):
        rc.range_count(x.to(torch.bfloat16), 2.0, 9.0)
    with pytest.raises(ValueError, match="int32 range"):
        rc.range_count(x.int(), 0, 2**40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(64, 512), (1 << 20,), (3, 5001), (2, 3, 33)]
                         + [(3, n) for n in EDGE_LENGTHS])
def test_hadd_kernel(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    if dtype == torch.int32:
        x = torch.randint(-1000, 1000, shape, generator=g, device=dev, dtype=dtype)
    else:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = ha.hadd.launches
    got, want = ha.hadd(x), ha.ref.hadd(x)
    assert got.shape == want.shape == shape[:-1]
    if dtype == torch.int32:
        _equal(got, want)
    else:
        _check(got, want, dtype)
    assert ha.hadd.launches == before + (shape[-1] > 0)


def test_hadd_kernel_int32_exact_past_2_24_and_wraps(dev):
    x = torch.full(((1 << 25) + 3,), 3, dtype=torch.int32, device=dev)   # 3 * 2^25 > 2^24
    _equal(ha.hadd(x), ha.ref.hadd(x))
    assert int(ha.hadd(x)) == 3 * ((1 << 25) + 3)
    w = torch.full((5000,), 1 << 20, dtype=torch.int32, device=dev)      # wraps past 2^31
    _equal(ha.hadd(w), ha.ref.hadd(w))


@pytest.mark.parametrize("rows,n", [(1, 32), (31, 32), (33, 32), ((1 << 20) + 7, 32),
                                    (7, 1), (7, 31), (0, 32), (5, 11)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_to_integral_kernel(dev, rows, n, dtype):
    g = torch.Generator(device=dev).manual_seed(rows)
    m = (torch.rand((rows, n), generator=g, device=dev) > 0.5).to(dtype)
    before = ti.to_integral.launches
    _equal(ti.to_integral(m), ti.ref.to_integral(m))
    assert ti.to_integral.launches == before + (rows > 0)


def test_to_integral_kernel_bit_31(dev):
    m = torch.zeros((3, 32), dtype=torch.bool, device=dev)
    m[0] = True
    m[1, 31] = True
    got = ti.to_integral(m)
    assert got.dtype == torch.uint32
    want = torch.tensor([-1, -(1 << 31), 0], dtype=torch.int32, device=dev)
    _equal(got.view(torch.int32), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 152064), (4096, 1024), (64, 512), (7, 33), (3, 9000),
                                   (2, 1), (2, 31), (2, 33), (2, (1 << 20) + 7)])
@pytest.mark.parametrize("scale", [4.0, 1.0])   # 1: flat rows, no entry dominates
def test_softmax_kernel(dev, shape, dtype, scale):
    g = torch.Generator(device=dev).manual_seed(shape[1])
    x = (torch.randn(shape, generator=g, device=dev) * scale)
    x[:, 1::7] = float("-inf")               # -inf lanes weigh 0
    x[0, : shape[1] // 2] = float("-inf")    # a first block of only -inf
    x = x.to(dtype)
    before = sm.softmax.launches
    got, want = sm.softmax(x), sm.ref.softmax(x)
    assert sm.softmax.launches == before + 1
    _check(got, want, dtype, row_width=shape[1])


def test_softmax_kernel_row_of_only_neg_inf_is_nan(dev):
    for d in (100, 9000):
        x = torch.randn((3, d), device=dev)
        x[1] = float("-inf")
        got, want = sm.softmax(x), sm.ref.softmax(x)
        torch.cuda.synchronize()
        assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
        _check(got[[0, 2]], want[[0, 2]], torch.float32, row_width=d)


def test_h100_library_creates_tensors_on_the_card_and_runs_the_app_there(dev):
    """load / set / set1 of the h100 library give CUDA tensors (they gave
    host tensors before the SRU's device was rendered into them), and the
    app's four ways count on the card."""
    import numpy as np

    from repro_torch import tsl_api
    from repro_torch.launch import quickstart

    ops = tsl_api.ops(dev)
    for t in (ops.load(np.ones(3, np.float32)), ops.set([1, 2], dtype="int32"),
              ops.set1(7, (2, 3), dtype=torch.float32)):
        assert t.device.type == "cuda"
    data = quickstart.make_data(1 << 20, "float32", dev)
    counts = quickstart.count_four_ways(ops, data, 5.0, 15.0)
    assert counts["fused"] == int(rc.ref.range_count(data.cpu(), 5.0, 15.0))
