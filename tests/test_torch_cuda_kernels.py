"""The Hopper kernels against their plain versions on the card. These run
only on an sm_90 card (marker ``cuda``) and skip elsewhere with the reason;
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The paged cases draw their tables as permutations of the pool with the
scratch page (0) padding each row past its coverage.

The training kernels (flash forward with lse, dq, dk/dv) and the gradients
of the rmsnorm / swiglu / flash wrappers are held to the scale-relative
card gates of repro_torch.gates (card_bf16: rel 1e-2, 2e-2 rms + 2^-7
|plain|; card_f32: rel 1e-5, 1e-4 rms + 1e-5 |plain|; the lse within 1e-5
max(1, |lse|) and exactly 0 on rows that see no key); the planted-fault
tests build faulted copies of the CUDA sources in a temporary directory and
show that each of those gates fails on them.

Tolerance: bf16 |kernel - plain| <= 1e-2 + 1e-2 |plain| (one bf16 rounding
step where f32 sums round differently); f32 1e-4 + 1e-4 |plain|. Softmax
compares d·softmax on rows of width d (mean 1), so its absolute term is
1e-2/d (bf16, f16) or 1e-4/d (f32) of a probability; float16 takes bf16's
tolerance (one rounding step: 2^-11 relative, or 2^-24 absolute below
2^-14, under 1e-2/d for d < 167772). Counts, int32 sums and packed words
are integers: equal, bit for bit."""

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
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4, torch.float16: 1e-2}


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
    # D 112 (zamba2's shared attention block): its prefill shape, a
    # continuation and a partial tile without causality
    (2, 32, 32, 512, 512, 112, True, None),
    (2, 4, 4, 64, 200, 112, True, 180),
    (1, 4, 2, 100, 77, 112, False, None),
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
    # contiguous, but 2 bytes off the 16-byte alignment the bf16 path's
    # cp.async copies need: the launch is refused, and the refusal raises
    q = rand(2 * 64 * 64 + 1)[1:].view(1, 2, 64, 64)
    with pytest.raises(RuntimeError, match="launch failed"):
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
    # a long context: 64-entry tables, each (sequence, KV head) split over blocks
    (8, 16, 16, 64, 64, 1, [3900, 3928, 3956, 3984, 4012, 4040, 4068, 4096], 64, 64),
    # batch-1 GQA (40 over 8 heads of 128) at kv_len 4096: 8 (sequence, KV
    # head) pairs, so the card fills only through the split
    (1, 40, 8, 128, 64, 1, [4096], 64, 64),
    # split tables with splits wholly past kv_len (kv_len 0: every split
    # empty), and split spans of 20 and 48 rows per KV head (2 and 1 warps
    # per 16-row m-tile), one with rows before the first key
    (4, 16, 16, 64, 64, 1, [0, 5, 700, 4096], 64, 64),
    (2, 40, 8, 128, 64, 4, [2, 3000], 64, 64),
    (1, 48, 4, 64, 64, 4, [1000], 64, 64),
    # D 112 (zamba2's shared attention block): the fused decode and verify
    # steps (32 heads, batch 8, page 64), edge lengths, and split tables
    (8, 32, 32, 112, 64, 1, [260, 268, 276, 284, 292, 300, 308, 316], 5, 64),
    (8, 32, 32, 112, 64, 5, [265, 273, 281, 289, 297, 305, 313, 321], 6, 64),
    (8, 32, 32, 112, 64, 1, [0, 1, 100, 320, 257, 64, 63, 200], 5, 64),
    (4, 32, 32, 112, 64, 1, [0, 5, 700, 4096], 64, 64),
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_is_the_same_bit_for_bit_call_after_call(dev, dtype):
    """The splits are merged in split order, never in arrival order."""
    for b, h, kh, d, page, sq, kv_lens, width, block_k in (PAGED_CASES[0], PAGED_CASES[-1]):
        q, k, v, tables, kv_len = _paged_operands(dev, dtype, b, h, kh, d, page, sq,
                                                  kv_lens, width)
        first = pa.paged_attention(q, k, v, tables, kv_len, block_k=block_k)
        for _ in range(3):
            assert torch.equal(pa.paged_attention(q, k, v, tables, kv_len, block_k=block_k),
                               first)


def test_paged_attention_rejects_what_it_does_not_take(dev):
    q, k, v, tables, kv_len = _paged_operands(dev, torch.bfloat16, 2, 4, 4, 64, 16, 1,
                                              [5, 9], 2)
    scales = torch.ones(k.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="int8"):          # scales beside bf16 pools
        pa.paged_attention(q, k, v, tables, kv_len, k_scale=scales, v_scale=scales)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadd_is_the_same_bit_for_bit_call_after_call(dev, dtype):
    """The last block adds the partials in index order, never in arrival order."""
    g = torch.Generator(device=dev).manual_seed(5)
    for shape in ((1 << 24,), (3, (1 << 20) + 7), (8, 152064)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        first = ha.hadd(x)
        for _ in range(3):
            assert torch.equal(ha.hadd(x), first)


@pytest.mark.parametrize("rows,n", [(1, 32), (31, 32), (33, 32), ((1 << 20) + 7, 32),
                                    (7, 1), (7, 31), (0, 32), (5, 11)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_to_integral_kernel(dev, rows, n, dtype):
    g = torch.Generator(device=dev).manual_seed(rows)
    m = (torch.rand((rows, n), generator=g, device=dev) > 0.5).to(dtype)
    before = ti.to_integral.launches
    _equal(ti.to_integral(m), ti.ref.to_integral(m))
    assert ti.to_integral.launches == before + (rows > 0)


def _random_bytes(dev, rows, seed):
    """(rows, 32) uint8 of random bytes 0-255, about half of them zeroed:
    every nonzero byte, not only 1, must set its lane."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randint(0, 256, (rows, 32), generator=g, device=dev, dtype=torch.uint8)
    return b * (torch.rand((rows, 32), generator=g, device=dev) > 0.5)


def _off_alignment(m):
    """``m`` copied into a view of a flat buffer at offset 1 (a base 1 byte
    off 16-byte alignment)."""
    flat = torch.empty(m.numel() + 1, dtype=m.dtype, device=m.device)
    view = flat[1:].view(m.shape)
    view.copy_(m)
    return view


# rows no multiple of a thread's 4 rows, a warp's 128 or a block's 1024
TO_INTEGRAL_ROWS = [1, 3, 33, 130, 1029, (1 << 16) + 3, (1 << 20) + 7]


@pytest.mark.parametrize("rows", TO_INTEGRAL_ROWS + [1 << 20])
@pytest.mark.parametrize("kind", ["bool", "random bytes"])
def test_to_integral_vector_body(dev, rows, kind):
    """n = 32 at an aligned base takes the vector body: bit for bit the
    plain version, one launch."""
    from repro_torch.kernels.to_integral import kernel

    g = torch.Generator(device=dev).manual_seed(rows)
    m = (_random_bytes(dev, rows, rows) if kind == "random bytes"
         else torch.rand((rows, 32), generator=g, device=dev) > 0.5)
    assert kernel.body(m) == "vector"
    before = ti.to_integral.launches
    _equal(ti.to_integral(m), ti.ref.to_integral(m))
    assert ti.to_integral.launches == before + 1


@pytest.mark.parametrize("rows", TO_INTEGRAL_ROWS)
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_to_integral_off_alignment_takes_the_ballot_body(dev, rows, dtype):
    from repro_torch.kernels.to_integral import kernel

    m = _off_alignment(_random_bytes(dev, rows, rows + 1).to(dtype))
    assert m.data_ptr() % 16 == 1 and kernel.body(m) == "ballot"
    _equal(ti.to_integral(m), ti.ref.to_integral(m))


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
                                   (2, 1), (2, 31), (2, 33), (2, (1 << 20) + 7),
                                   (1, 152064), (2, 152063), (2, (1 << 20) + 8)])
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


def test_softmax_kernel_float16(dev):
    x = torch.randn((8, 152064), generator=torch.Generator(device=dev).manual_seed(16),
                    device=dev) * 4
    x[:, 1::7] = float("-inf")
    x = x.half()
    got, want = sm.softmax(x), sm.ref.softmax(x)
    assert got.dtype == torch.float16
    _check(got, want, torch.float16, row_width=x.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_off_alignment_takes_element_loads(dev, dtype):
    """A contiguous view whose base is one element off 16-byte alignment:
    the plan takes element loads, never the bulk copy, and is right."""
    x = torch.randn((8, 152064), generator=torch.Generator(device=dev).manual_seed(17),
                    device=dev).mul_(4).to(dtype)
    view = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape)
    view.copy_(x)
    got = sm.softmax(view)
    assert view.data_ptr() % 16 != 0 and sm.kernel.plan_for(view, got).load == "element"
    assert sm.kernel.plan_for(x, sm.softmax(x)).load == "bulk"
    _check(got, sm.ref.softmax(view), dtype, row_width=x.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_is_the_same_bit_for_bit_call_after_call(dev, dtype):
    """Every CTA of a cluster merges the partials in rank order, so the wide
    kernel's output never depends on which CTA finished first."""
    g = torch.Generator(device=dev).manual_seed(18)
    for shape in ((8, 152064), (1, 152064), (2, 152063), (2, (1 << 20) + 7)):
        x = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
        first = sm.softmax(x)
        for _ in range(3):
            assert torch.equal(sm.softmax(x), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_cluster_of_8(dev, dtype):
    """The portable cluster size, as chip_smoke.py times it beside 16."""
    x = (torch.randn((8, 152064), generator=torch.Generator(device=dev).manual_seed(19),
                     device=dev) * 4).to(dtype)
    out = torch.empty_like(x)
    sm.kernel.softmax_2d(x, out, max_cluster=8)
    assert sm.kernel.plan_for(x, out, max_cluster=8).cluster == 8
    _check(out, sm.ref.softmax(x), dtype, row_width=x.shape[1])


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


# the training kernels: phase 5a's shapes, then the seven cases of
# tests/test_flash_attention_grad.py at D 64 (b, h, kh, sq, sk, d, causal, kv_len)
TRAIN_CASES = [
    (8, 16, 16, 512, 512, 64, True, None),
    (2, 40, 8, 512, 512, 128, True, None),
    (2, 16, 16, 64, 320, 64, True, 300),
    (1, 8, 4, 200, 72, 64, True, None),
    (1, 2, 2, 64, 64, 64, True, None),
    (2, 4, 2, 96, 160, 64, True, None),
    (1, 2, 1, 64, 64, 64, False, None),
    (1, 2, 2, 40, 64, 64, False, 48),
    (1, 4, 2, 1, 64, 64, True, 40),
    (1, 2, 2, 16, 64, 64, True, 40),
]
CARD_GATE = {torch.bfloat16: "card_bf16", torch.float32: "card_f32"}
# the training kernels at D 112: zamba2-7b's shared block (32 heads, causal),
# kv_len < Sk with a tile crossed by the kv_len edge and a ragged q tile, and
# GQA non-causal at Sq != Sk
D112_TRAIN_CASES = [
    (2, 32, 32, 512, 512, 112, True, None),
    (2, 32, 32, 400, 512, 112, True, 400),
    (1, 4, 2, 96, 160, 112, False, None),
]


def _train_check(dev, case, dtype, seed=0):
    """The three training kernels against their plain versions on the same
    inputs (the plain lse and delta feed both backward versions); raises
    AssertionError on the first gate that fails."""
    from repro_torch import gates

    b, h, kh, sq, sk, d, causal, kv_len = case
    rand = _draws(dev, dtype, seed)
    q, k, v, do = rand(b, h, sq, d), rand(b, kh, sk, d), rand(b, kh, sk, d), rand(b, h, sq, d)
    kw = dict(causal=causal, kv_len=kv_len)
    gate = CARD_GATE[dtype]
    ref = fa.ref
    no_key = ~ref.visible(sq, sk, device=dev, **kw).any(-1)
    before = [f.launches for f in (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    out_r, lse_r = ref.attention_fwd_lse(q, k, v, **kw)
    delta = (do.float() * out_r.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
    torch.cuda.synchronize()
    after = [f.launches for f in (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                                  fa.flash_attention_bwd_dkv)]
    assert after == [n + 1 for n in before]
    gates.check(out, out_r, gate, "out")
    gates.check_lse(lse, lse_r, no_key, "lse")
    gates.check(dq, ref.attention_bwd_dq(q, k, v, do, lse_r, delta, **kw), gate, "dq")
    assert torch.count_nonzero(dq[:, :, no_key]) == 0
    dk_r, dv_r = ref.attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
    gates.check(dk, dk_r, gate, "dk")
    gates.check(dv, dv_r, gate, "dv")


def _glue_check(dev, case, dtype, seed=0):
    """FlashAttention on the card (kernels + delta + head-group sum + casts)
    against autograd through the plain attention: card_f32 in f32, the
    full-width gate (rel 5e-2) in bf16, where autograd rounds elsewhere."""
    from repro_torch import gates

    b, h, kh, sq, sk, d, causal, kv_len = case
    rand = _draws(dev, dtype, seed)
    q, k, v, do = rand(b, h, sq, d), rand(b, kh, sk, d), rand(b, kh, sk, d), rand(b, h, sq, d)
    kw = dict(causal=causal, kv_len=kv_len)
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*got, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.ref.attention(*want, **kw).backward(do)
    gate = "card_f32" if dtype == torch.float32 else "full_width_bf16"
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.grad.dtype == dtype
        gates.check(a.grad, w.grad, gate, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", TRAIN_CASES + D112_TRAIN_CASES)
def test_flash_attention_training_kernels(dev, case, dtype):
    _train_check(dev, case, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [TRAIN_CASES[1], TRAIN_CASES[3], TRAIN_CASES[5]])
def test_flash_attention_function_matches_autograd_of_plain(dev, case, dtype):
    _glue_check(dev, case, dtype)


def test_flash_attention_training_kernels_reject_what_they_do_not_take(dev):
    rand = _draws(dev, torch.bfloat16)
    q = rand(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd_lse(q, q, q)
    q = rand(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse.double(), lse)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse[:, :1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_keep_the_graph_and_match_plain_gradients(dev, dtype):
    """rmsnorm, swiglu and flash attention on the card return tensors with a
    grad_fn when an input requires grad (their kernels still launch), and
    their gradients equal the plain versions' under the card gates."""
    from repro_torch import gates

    rand = _draws(dev, dtype)
    gate = CARD_GATE[dtype]
    x, w, up, gy = rand(64, 1024), rand(1024), rand(64, 1024), rand(64, 1024)
    for name, wrapper, plain, args in (("rmsnorm", rn.rmsnorm, rn.ref.rmsnorm, (x, w)),
                                       ("swiglu", sw.swiglu, sw.ref.swiglu, (x, up))):
        got_in = [t.clone().requires_grad_() for t in args]
        want_in = [t.clone().requires_grad_() for t in args]
        before = wrapper.launches
        y = wrapper(*got_in)
        assert wrapper.launches == before + 1, name
        assert y.grad_fn is not None, name
        y.backward(gy)
        plain(*want_in).backward(gy)
        for a, b_ in zip(got_in, want_in):
            gates.check(a.grad, b_.grad, gate, f"{name} grad")
    before = fa.flash_attention_fwd_lse.launches
    _glue_check(dev, (2, 4, 2, 128, 128, 64, True, None), dtype)
    assert fa.flash_attention_fwd_lse.launches == before + 1


# planted faults in copies of the CUDA sources: (file, old, new). Each must
# make the card gates fail; the copies are built from a temporary directory.
# Every fault is planted in both paths of its source, the bf16 tensor-core
# kernels and the float32 scalar ones, so it shows in both dtypes (the
# masking helper of flash_attention_bwd.cu serves both bf16 kernels).
# tests/test_torch_kernel_sources.py checks on the host that every `old`
# string is still in its source, once.
CUDA_FAULTS = {
    "dk_one_head_zeroed": [("flash_attention_bwd.cu", "dk[at] = acc_k[j] * scale;",
                            "dk[at] = h == H - 1 ? 0.f : acc_k[j] * scale;"),
                           ("flash_attention_bwd.cu", "const float dk_scale = scale;",
                            "const float dk_scale = h == H - 1 ? 0.f : scale;")],
    "dq_scale_dropped": [("flash_attention_bwd.cu", "from_f32<T>(acc[j] * scale)",
                          "from_f32<T>(acc[j])"),
                         ("flash_attention_bwd.cu", "dq_acc[j][e] *= scale;",
                          "dq_acc[j][e] *= 1.f;")],
    "lse_not_zeroed_on_rows_without_keys": [
        ("flash_attention.cu", "l[r] > 0.f ? m_run[r] * kLn2 + logf(l[r]) : 0.f;",
         "m_run[r] * kLn2 + logf(l[r]);"),
        ("flash_attention.cu", "l > 0.f ? row_m[tid] + logf(l) : 0.f;",
         "row_m[tid] + logf(l);")],
    "causal_diagonal_off_by_one": [
        ("flash_attention.cu", "causal && kpos > qpos + q_offset",
         "causal && kpos >= qpos + q_offset"),
        ("flash_attention.cu", "kpos <= q0 + r + q_offset", "kpos < q0 + r + q_offset"),
        ("flash_attention_bwd.cu", "kpos <= qpos + q_offset", "kpos < qpos + q_offset"),
        ("flash_attention_bwd.cu", "(causal && kpos > qpos + q_offset)",
         "(causal && kpos >= qpos + q_offset)")],
    # the online softmax's rescale of the running sum and output dropped
    "softmax_rescale_dropped": [
        ("flash_attention.cu", "const float corr = exp2f(m_run[r] - m_use);",
         "const float corr = 1.f;"),
        ("flash_attention.cu", "const float corr = expf(m_prev - m_new);",
         "const float corr = 1.f;")],
    # dk/dv's walk over the q tiles starts one tile late: the diagonal tile
    # (or, without causality, the first) is skipped
    "dkv_q_walk_starts_one_tile_late": [
        ("flash_attention_bwd.cu", "const int qt_begin = q_begin / TILE;",
         "const int qt_begin = q_begin / TILE + 1;"),
        ("flash_attention_bwd.cu", "const int qt_first = q_first / TILE;",
         "const int qt_first = q_first / TILE + 1;")],
}


def _plant_cuda_fault(tmp_path, monkeypatch, fault):
    """Build copies of the CUDA sources with ``fault`` and make the kernel
    launchers call them for the rest of the test."""
    from repro_torch.kernels.common import load_shared_library
    from repro_torch.kernels.flash_attention import kernel

    for header in kernel.HEADERS:
        (tmp_path / header.name).write_text(header.read_text())
    for src in kernel.SOURCES + kernel.BWD_SOURCES:
        text = src.read_text()
        for name, old, new in CUDA_FAULTS[fault]:
            if name == src.name:
                assert old in text, (fault, old)
                text = text.replace(old, new)
        (tmp_path / src.name).write_text(text)
    fwd = kernel.bind_fwd(load_shared_library(f"fault_{fault}_fwd",
                                              [tmp_path / "flash_attention.cu"]))
    bwd = kernel.bind_bwd(load_shared_library(f"fault_{fault}_bwd",
                                              [tmp_path / "flash_attention_bwd.cu"]))
    monkeypatch.setattr(kernel, "_fn", lambda: fwd)
    monkeypatch.setattr(kernel, "_bwd_fns", lambda: bwd)


def _faulted_ops(fault):
    """A fresh ops module with the glue ``fault`` (GLUE_FAULTS) in its source."""
    import types
    from pathlib import Path

    old, new = GLUE_FAULTS[fault]
    src = Path(fa.__file__).read_text()
    assert old in src
    mod = types.ModuleType("repro_torch.kernels.flash_attention.ops_faulted")
    mod.__package__ = "repro_torch.kernels.flash_attention"
    exec(compile(src.replace(old, new), "<ops.py faulted>", "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", list(CUDA_FAULTS))
def test_card_gates_fail_on_planted_kernel_fault(dev, tmp_path, monkeypatch, fault, dtype):
    """A copy of the kernels with ``fault`` must fail a card gate on at
    least one of the training cases (and the unfaulted kernels pass them:
    test_flash_attention_training_kernels)."""
    _plant_cuda_fault(tmp_path, monkeypatch, fault)
    caught = []
    for case in TRAIN_CASES[1:]:
        try:
            _train_check(dev, case, dtype)
        except AssertionError as e:
            caught.append(f"{case}: {e}")
    print(f"\n[fault] {fault} {dtype}: {len(caught)} of {len(TRAIN_CASES) - 1} cases fail "
          f"a card gate; first: {caught[0][:200] if caught else '-'}")
    assert caught, f"no card gate fails on {fault}"


# planted faults in the Python glue around the kernels (ops.py): the
# delta, the head-group sum. The kernels' own gates cannot see them (both
# sides get the same lse and delta); FlashAttention vs autograd of the
# plain attention does, at a GQA shape.
GLUE_FAULTS = {
    "gqa_sum_group_0_only": (".sum(2).to(", "[:, :, 0].to("),
    "delta_from_bf16_product": ("delta = (g.float() * out.float()).sum(-1)",
                                "delta = (g.float() * out.float()).bfloat16().float().sum(-1)"),
}


# delta from the bf16-rounded product is run in f32 only, where card_f32
# sees it. In bf16 no gate here can: the rounding it adds (2^-9 of each term
# of delta) is the size of the rounding the sound glue already carries
# (delta from the bf16 forward output), so no fixed tolerance on the bf16
# glue separates the two; the host_bf16 gate catches it on the host's
# inputs, and full_width_f32 at full width
@pytest.mark.parametrize("fault,dtype", [("gqa_sum_group_0_only", torch.bfloat16),
                                         ("gqa_sum_group_0_only", torch.float32),
                                         ("delta_from_bf16_product", torch.float32)])
def test_card_glue_gate_fails_on_planted_fault(dev, monkeypatch, fault, dtype):
    monkeypatch.setattr(fa, "flash_attention", _faulted_ops(fault).flash_attention)
    caught = []
    for case in (TRAIN_CASES[1], TRAIN_CASES[3], TRAIN_CASES[5]):
        try:
            _glue_check(dev, case, dtype)
        except AssertionError as e:
            caught.append(f"{case}: {e}")
    print(f"\n[fault] {fault} {dtype}: {len(caught)} of 3 cases fail the glue gate; "
          f"first: {caught[0][:200] if caught else '-'}")
    assert caught, f"no card gate fails on {fault}"


# The full-width gates (qwen1.5-0.5b, 24 layers, batch 2 x 512), kernels vs
# plain versions under each planted fault: with bf16 params the bf16
# gates (every grad leaf within rel 5e-2, the 5-step loss curve within 5e-3
# of the loss), with float32 params full_width_f32 (every leaf within rel
# 1e-4) and LOSS_REL_F32 (1e-4), where no bf16 rounding hides a fault.
#
# Two faults change nothing at this configuration, by construction: qwen1.5
# is MHA, so a head-group "sum" over one head is that head
# (gqa_sum_group_0_only), and causal self-attention with Sq = Sk has no row
# without keys (lse_not_zeroed_on_rows_without_keys). Every gate must pass
# them. Every other fault must fail the float32 grads gate. NOT_SEEN lists
# the (fault, gate) pairs that pass although the fault is live: each is a
# fault that gate does not show. They are printed, not asserted.
# Measured on the card (H100 80GB HBM3, 700 W, the tensor-core forward) with
# bf16 params: under the delta fault the worst leaf reads rel 0.0278, as the
# sound run's does, and the loss curve 1.72e-3 of the loss; one head's dk
# zeroed moves the loss curve by 1.35e-3, while the sound run's own curve
# differs by 9.8e-4. With float32 params the delta fault moves the loss curve
# by 9.66e-5 of the loss, just inside LOSS_REL_F32, and the worst leaf to rel
# 3.3e-3.
NO_OP_AT_FULL_WIDTH = {"gqa_sum_group_0_only", "lse_not_zeroed_on_rows_without_keys"}
NOT_SEEN = {("delta_from_bf16_product", "grads_bf16"), ("delta_from_bf16_product", "loss_bf16"),
            ("delta_from_bf16_product", "loss_f32"), ("dk_one_head_zeroed", "loss_bf16")}
_FULL_WIDTH_PLAIN = {}


# Planted faults of the kernels that split a reduction over blocks and finish
# it in the same launch. The paged faults sit in code both of its paths run
# (the split's key range and the merge), so each shows in bf16 and in
# float32. tests/test_torch_kernel_sources.py checks on the host that every
# `old` string is still in its source, once.
PAGED_FAULTS = {
    "merge_rescale_dropped": [
        ("paged_attention.cu", "const float w = l_j[i] > 0.f ? ex<LOG2>(m_j[i] - M) : 0.f;",
         "const float w = l_j[i] > 0.f ? 1.f : 0.f;")],
    "last_split_skipped": [("paged_attention.cu", "for (int j = j0; j < S; j += dj) {",
                            "for (int j = j0; j < S - 1; j += dj) {")],
    "split_boundary_one_page_late": [("paged_attention.cu", "sp.e0 = s * pps;",
                                      "sp.e0 = s * pps + 1;")],
}
HADD_FAULTS = {
    "last_partial_skipped": [("hadd.cu", "i < splits; i += NT) sum +=",
                              "i < splits - 1; i += NT) sum +=")],
}
# The vector body's pack and unroll (to_integral.cu); the random-byte masks
# show the byte test, which bool masks (bytes 0 and 1) cannot.
TO_INTEGRAL_FAULTS = {
    "bytes_1_and_2_swapped": [("to_integral.cu", "__vcmpne4(w, 0u) & 0x08040201u",
                               "__vcmpne4(w, 0u) & 0x08020401u")],
    "last_unrolled_row_skipped": [("to_integral.cu", "for (int s = 0; s < R; ++s)",
                                   "for (int s = 0; s < R - 1; ++s)")],
    "byte_tested_with_and_1": [("to_integral.cu", "__vcmpne4(w, 0u) & 0x08040201u",
                                "(w & 0x01010101u) * 0xFFu & 0x08040201u")],
}


# The wide softmax's split and merge (softmax.cu): each must fail phase 1's
# softmax check (chip_smoke.check_case on chip_smoke.softmax_specs) in f32
# and in bf16.
SOFTMAX_FAULTS = {
    "cluster_merge_rescale_dropped": [("softmax.cu", "const float w = p.y * exp2f(p.x - M);",
                                       "const float w = p.y;")],
    "last_rank_skipped": [("softmax.cu", "lane < S ? *cluster.map_shared_rank(&part, lane)",
                           "lane < S - 1 ? *cluster.map_shared_rank(&part, lane)")],
    "chunk_boundary_one_element_late": [
        ("softmax.cu", "const long long c0 = static_cast<long long>(rank) * cs;",
         "const long long c0 = static_cast<long long>(rank) * cs + 1;")],
    "local_neg_inf_guard_dropped": [("softmax.cu", "  if (m > -INFINITY) {", "  if (true) {")],
}


def _plant_split_fault(tmp_path, monkeypatch, kernel, faults, name):
    """Build a copy of ``kernel``'s source with ``faults`` (and its headers
    beside it) and make its launcher call it for the rest of the test."""
    from repro_torch.kernels.common import load_shared_library

    headers = getattr(kernel, "HEADERS", [])
    for header in headers:
        (tmp_path / header.name).write_text(header.read_text())
    (src,) = kernel.SOURCES
    text = src.read_text()
    for fname, old, new in faults:
        assert fname == src.name and old in text, (name, old)
        text = text.replace(old, new)
    (tmp_path / src.name).write_text(text)
    fn = kernel.bind(load_shared_library(f"fault_{name}", [tmp_path / src.name],
                                         [tmp_path / h.name for h in headers]))
    monkeypatch.setattr(kernel, "_fn", lambda: fn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", list(PAGED_FAULTS))
def test_paged_check_fails_on_planted_fault(dev, tmp_path, monkeypatch, fault, dtype):
    """A copy of the paged kernel with ``fault`` must fail _check on at least
    one PAGED_CASE (the unfaulted kernel passes them all:
    test_paged_attention_kernel)."""
    _plant_split_fault(tmp_path, monkeypatch, pa.kernel, PAGED_FAULTS[fault], f"paged_{fault}")
    caught = []
    for b, h, kh, d, page, sq, kv_lens, width, block_k in PAGED_CASES:
        q, k, v, tables, kv_len = _paged_operands(dev, dtype, b, h, kh, d, page, sq,
                                                  kv_lens, width)
        try:
            _check(pa.paged_attention(q, k, v, tables, kv_len, block_k=block_k),
                   pa.ref.paged_attention_ref(q, k, v, tables, kv_len), dtype)
        except AssertionError as e:
            caught.append(f"{(b, h, kh, d, page, sq, width)}: {str(e)[:120]}")
    print(f"\n[fault] {fault} {dtype}: {len(caught)} of {len(PAGED_CASES)} cases fail; "
          f"first: {caught[0] if caught else '-'}")
    assert caught, f"no paged case fails on {fault}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("fault", list(HADD_FAULTS))
def test_hadd_check_fails_on_planted_fault(dev, tmp_path, monkeypatch, fault, dtype):
    _plant_split_fault(tmp_path, monkeypatch, ha.kernel, HADD_FAULTS[fault], f"hadd_{fault}")
    g = torch.Generator(device=dev).manual_seed(6)
    caught = []
    for shape in ((1 << 20,), (3, (1 << 20) + 7)):
        if dtype == torch.int32:
            x = torch.randint(-1000, 1000, shape, generator=g, device=dev, dtype=dtype)
        else:
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
        try:
            (_equal if dtype == torch.int32 else
             lambda got, want: _check(got, want, dtype))(ha.hadd(x), ha.ref.hadd(x))
        except AssertionError as e:
            caught.append(f"{shape}: {str(e)[:120]}")
    assert caught, f"no hadd case fails on {fault}"


@pytest.mark.parametrize("fault", list(TO_INTEGRAL_FAULTS))
def test_to_integral_check_fails_on_planted_fault(dev, tmp_path, monkeypatch, fault):
    """A copy of the movemask with ``fault`` must fail the bit-for-bit check
    on the vector body's cases (the unfaulted kernel passes them all:
    test_to_integral_vector_body). Each output buffer is filled with a
    pattern first, so a word the fault leaves unwritten cannot read as
    right from an earlier call's memory."""
    _plant_split_fault(tmp_path, monkeypatch, ti.kernel, TO_INTEGRAL_FAULTS[fault],
                       f"to_integral_{fault}")
    caught = []
    for rows in (1029, 1 << 20):
        for m in (_random_bytes(dev, rows, rows),
                  torch.rand((rows, 32), device=dev) > 0.5):
            out = torch.full((rows,), 0x5A5A5A5A, dtype=torch.int32,
                             device=dev).view(torch.uint32)
            ti.kernel.to_integral_2d(m, out)
            try:
                _equal(out, ti.ref.to_integral(m))
            except AssertionError as e:
                caught.append(f"{tuple(m.shape)} {m.dtype}: {str(e)[:80]}")
    print(f"\n[fault] {fault}: {len(caught)} of 4 cases fail")
    assert caught, f"no to_integral case fails on {fault}"


def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", list(SOFTMAX_FAULTS))
def test_softmax_check_fails_on_planted_fault(dev, tmp_path, monkeypatch, fault, dtype):
    """A copy of the softmax kernel with ``fault`` must fail phase 1's check
    on at least one of phase 1's cases of ``dtype`` (the unfaulted kernel
    passes them all: chip_smoke.py). Each output is filled with NaN first,
    so an element the fault leaves unwritten cannot read as right from an
    earlier call's memory."""
    cs = _chip_smoke()
    _plant_split_fault(tmp_path, monkeypatch, sm.kernel, SOFTMAX_FAULTS[fault],
                       f"softmax_{fault}")
    caught, tried = [], 0
    for x, _, note in cs.softmax_specs(dev):
        if x.dtype != dtype:
            continue
        tried += 1
        out = torch.full_like(x, float("nan"))
        sm.kernel.softmax_2d(x, out)
        try:
            cs.check_case("softmax", list(x.shape), out, sm.ref.softmax(x), dtype,
                          nan_ok=True, atol_scale=1 / x.shape[-1])
        except AssertionError as e:
            caught.append(f"{tuple(x.shape)}{' ' + note if note else ''}: {str(e)[:90]}")
    print(f"\n[fault] {fault} {dtype}: {len(caught)} of {tried} cases fail: "
          + " | ".join(caught))
    assert caught, f"no softmax case fails on {fault}"


def _full_width_run(model, state, batch, steps=5):
    """Every grad leaf at ``state`` and the loss at each of ``steps`` steps."""
    from repro_torch.train import OptConfig, loss_and_grads, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    grads = tree_leaves(loss_and_grads(model, state["params"], batch)[2])
    step, losses, s = make_train_step(model, OptConfig(lr=3e-4, warmup_steps=0)), [], state
    for _ in range(steps):
        s, m = step(s, batch)
        losses.append(m["loss"].item())
    return grads, losses


def _full_width_setup(dev):
    """The models, states and batch of the full-width fault test, and the
    plain versions' grads and loss curves (computed once)."""
    from repro_torch.configs import get_config
    from repro_torch.nn.model import build_model
    from repro_torch.train import OptConfig, init_opt_state, init_train_state
    from repro_torch.train.optimizer import tree_map

    if not _FULL_WIDTH_PLAIN:
        cfg = get_config("qwen1.5-0.5b")
        state = init_train_state(build_model(cfg, device=dev),
                                 OptConfig(lr=3e-4, warmup_steps=0), seed=0)
        params_f32 = tree_map(lambda t: t.float(), state["params"])
        g = torch.Generator(device=dev).manual_seed(21)
        seq = torch.randint(0, cfg.vocab, (2, 513), generator=g, device=dev)
        batch = {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}
        for dtype, st in (("bf16", state),
                          ("f32", {"params": params_f32, "opt": init_opt_state(
                              OptConfig(lr=3e-4, warmup_steps=0), params_f32)})):
            c = cfg if dtype == "bf16" else cfg.replace(dtype="float32")
            _FULL_WIDTH_PLAIN[dtype] = {
                "state": st, "batch": batch, "kernels": build_model(c, device=dev),
                "plain": _full_width_run(build_model(c, device=dev, target="torch_cpu"),
                                         st, batch)}
    return _FULL_WIDTH_PLAIN


@pytest.mark.parametrize("fault", list(CUDA_FAULTS) + list(GLUE_FAULTS))
def test_full_width_gates_on_planted_fault(dev, tmp_path, monkeypatch, fault):
    from repro_torch import gates

    runs = _full_width_setup(dev)
    if fault in CUDA_FAULTS:
        _plant_cuda_fault(tmp_path, monkeypatch, fault)
    else:
        monkeypatch.setattr(fa, "_backward", _faulted_ops(fault)._backward)
    fails = {}
    for dtype, run in runs.items():
        want, losses_plain = run["plain"]
        got, losses = _full_width_run(run["kernels"], run["state"], run["batch"])
        gate, loss_rel = (("full_width_bf16", gates.LOSS_REL) if dtype == "bf16" else
                          ("full_width_f32", gates.LOSS_REL_F32))
        worst_rel = max(gates.measure(a, w, gate)["rel"] for a, w in zip(got, want))
        zero = any(not bool((a != 0).any()) for a in got)
        worst_loss = max(abs(a - p) / abs(p) for a, p in zip(losses, losses_plain))
        fails[f"grads_{dtype}"] = zero or not worst_rel <= gates.GATES[gate][0]
        fails[f"loss_{dtype}"] = not worst_loss <= loss_rel
        print(f"\n[fault] {fault} full width {dtype}: grads gate "
              f"{'FAILS' if fails[f'grads_{dtype}'] else 'passes'} (worst leaf rel "
              f"{worst_rel:.3g}, all-zero leaf {zero}), loss-curve gate "
              f"{'FAILS' if fails[f'loss_{dtype}'] else 'passes'} (worst |dloss|/loss "
              f"{worst_loss:.3g})")
    if fault in NO_OP_AT_FULL_WIDTH:
        assert not any(fails.values()), (fault, fails)
        return
    assert fails["grads_f32"], fault
    for gate, failed in fails.items():
        assert failed or (fault, gate) in NOT_SEEN, (fault, gate)
