"""The softmax kernel's host side, without a card: kernel.plan, the pure
function of the shape, the base alignment and the card that picks the
regime, the cluster size and the chunks each CTA of a row owns
(src/repro_torch/kernels/softmax/csrc/softmax.cu runs what it returns), and
ref.softmax_split, the kernel's cluster arithmetic written plainly (a
float32 (m, l) per chunk, merged in chunk order), held against the JAX
package's oracle (repro.kernels.softmax.ref) on the same seeded numpy
inputs.

Tolerances: those of test_torch_calc.test_softmax_ref_matches_jax, on
d·softmax for rows of width d (mean 1): float32 1e-6, bfloat16 1e-2 (both
frameworks round the same f32 statistics to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.softmax import ref as jax_sm
from repro_torch.kernels.softmax import kernel
from repro_torch.kernels.softmax import ref as sm_ref

SOFTMAX_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
SMS = 132                                   # an H100 SXM
WIDTHS = [1, 31, 33, 9000, 152063, 152064, (1 << 20) + 7]
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _tiles(p, d):
    """Raise unless p.chunks tiles [0, d) in order, no gap, no overlap, none
    empty, one chunk per CTA of the cluster."""
    assert len(p.chunks) == p.cluster >= 1
    assert p.chunks[0][0] == 0 and p.chunks[-1][1] == d
    for (a0, a1), (b0, _) in zip(p.chunks, p.chunks[1:]):
        assert a1 == b0
    assert all(c1 > c0 for c0, c1 in p.chunks)


@pytest.mark.parametrize("rows", [1, 8, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_plan_tiles_each_row_exactly(d, dtype, rows):
    itemsize = ITEMSIZE[dtype]
    for aligned in (True, False):
        p = kernel.plan(rows, d, itemsize, SMS, aligned)
        _tiles(p, d)
        if d <= kernel.NARROW_MAX:          # widths 1, 31, 33: a warp, no chunking
            assert (p.regime, p.cluster, p.smem) == ("narrow", 1, 0)
            assert d <= 32 * p.lane and p.lane in (4, 8, 16, 32)
            continue
        assert 1 <= p.cluster <= kernel.MAX_CLUSTER
        assert all(c0 * itemsize % 16 == 0 for c0, _ in p.chunks)   # whole vectors
        streams = p.chunk * itemsize > kernel.SMEM_BUDGET
        assert p.regime == ("stream" if streams else "wide")
        assert p.smem == (0 if streams else p.chunk * itemsize)
        vec = aligned and d * itemsize % 16 == 0
        assert p.load == ("element" if not vec else "vector" if streams else "bulk")


def test_plan_at_the_vocabulary_row():
    """(8, 152064): 16 CTAs a row, 128 in all, 9504 elements each (19 KB in
    bf16, 38 KB in f32) copied in bulk; S = 8 halves the CTAs; one row of 2^20
    + 7 f32 streams (4 MB > 16 x 224 KB), in bf16 it fits."""
    for itemsize in (2, 4):
        p = kernel.plan(8, 152064, itemsize, SMS)
        assert (p.regime, p.cluster, p.chunk, p.load) == ("wide", 16, 9504, "bulk")
        assert p.smem == 9504 * itemsize
        p8 = kernel.plan(8, 152064, itemsize, SMS, max_cluster=8)
        assert (p8.cluster, p8.chunk) == (8, 19008)
    assert kernel.plan(1, 152064, 2, SMS).cluster == 16
    assert kernel.plan(2, 152063, 2, SMS).load == "element"          # rows off 16 bytes
    assert kernel.plan(8, 152064, 2, SMS, aligned=False).load == "element"
    assert kernel.plan(2, (1 << 20) + 7, 4, SMS).regime == "stream"
    assert kernel.plan(2, (1 << 20) + 8, 4, SMS).load == "vector"
    assert kernel.plan(2, (1 << 20) + 7, 2, SMS).regime == "wide"
    p = kernel.plan(4096, 1024, 4, SMS)
    assert (p.regime, p.lane, p.load) == ("narrow", 32, "vector")
    assert kernel.plan(64, 512, 2, SMS).load == "vector"
    assert kernel.plan(4, 16, 2, SMS).load == "element"             # 4 a lane < 8 a vector
    assert kernel.plan(4096, 2048, 4, SMS).cluster == 1              # rows fill the card


def test_plan_depends_on_nothing_but_its_arguments(monkeypatch):
    """No card, no device query, no data: the same arguments give the same
    plan, whatever the process has seen."""
    def refuse(*a, **k):
        raise AssertionError("plan asked the device")

    monkeypatch.setattr(kernel, "sm_count", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "current_device", refuse)
    first = [kernel.plan(r, d, s, SMS) for r in (1, 3, 8) for d in WIDTHS for s in (2, 4)]
    torch.manual_seed(1)
    np.random.seed(1)
    assert first == [kernel.plan(r, d, s, SMS) for r in (1, 3, 8) for d in WIDTHS for s in (2, 4)]


def _even_chunks(d, k):
    edges = np.linspace(0, d, k + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 7, 16])
def test_softmax_split_matches_jax(k, dtype):
    """Rows with -inf lanes, a first half of only -inf (whole chunks of only
    -inf from k = 2 on) and a row of only -inf (NaN in both)."""
    d = 3000
    x = np.random.default_rng(k).uniform(-4, 4, (4, d)).astype(np.float32)
    x[:, 1::7] = -np.inf
    x[0, : d // 2] = -np.inf
    x[1] = -np.inf
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_sm.softmax(jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = sm_ref.softmax_split(tx, _even_chunks(d, k))
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    assert not np.isnan(got[[0, 2, 3]]).any()
    tol = SOFTMAX_TOL[dtype]
    np.testing.assert_allclose(got * d, want * d, rtol=tol, atol=tol)


@pytest.mark.parametrize("d,itemsize", [(9000, 4), (152064, 2), (152063, 2)])
def test_softmax_split_on_the_plans_chunks_matches_jax(d, itemsize):
    """The kernel's own chunking (kernel.plan at 2 rows) through the plain
    arithmetic, float32 statistics."""
    x = np.random.default_rng(d).uniform(-4, 4, (2, d)).astype(np.float32)
    x[:, ::7] = -np.inf
    p = kernel.plan(2, d, itemsize, SMS)
    assert p.cluster > 1
    want = np.asarray(jax_sm.softmax(jnp.asarray(x)))
    got = sm_ref.softmax_split(torch.from_numpy(x), p.chunks).numpy()
    np.testing.assert_allclose(got * d, want * d, rtol=SOFTMAX_TOL["float32"],
                               atol=SOFTMAX_TOL["float32"])
