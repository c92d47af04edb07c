"""The port's paged kernel module against the JAX package: the plain
versions (``repro_torch.kernels.paged.ref``: block-table attention, page
gather and scatter) against ``repro.kernels.paged.ref`` on the same seeded
numpy inputs, the CPU side of the wrapper, and one fused paged decode step
of reduced qwen1.5 against the reference model's. The generated
``torch_cpu`` library's cache_page_read / cache_page_write /
attention_decode_paged are held against ``load_library("cpu_xla")`` with
the other primitives in test_torch_generator.py.

All comparisons in f32. Tolerances: the kernels' plain versions within
1e-5 absolute + 1e-5 relative (different summation orders and exp, never bit
for bit); page gathers and scatters move data and must be exact; the model
step's logits within 1e-4 + 1e-4 (two layers of f32 matmuls, as in
test_torch_lm.py) and its pools within 1e-5 + 1e-5, where only the rows the
step wrote may differ from the pools it was given."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.paged import ref as jax_paged
from repro.nn.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels.paged import ops as paged_ops
from repro_torch.kernels.paged import ref as paged
from repro_torch.nn.model import build_model, load_jax_params

ATOL = RTOL = 1e-5


def _rand(rng, *shape):
    return rng.uniform(-2.0, 2.0, shape).astype(np.float32)


def _tables(rng, kv_lens, page, width):
    """Each sequence's pages: a slice of one permutation of the pool; page 0
    is the scratch page and pads every row past its coverage."""
    used = [-(-n // page) for n in kv_lens]
    n_pages = 1 + sum(used) + 1
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((len(kv_lens), width), np.int32)
    for i, u in enumerate(used):
        tables[i, :u] = perm[:u]
        perm = perm[u:]
    return tables, n_pages


@pytest.mark.parametrize("pages_per_step", [1, 4])
@pytest.mark.parametrize("kv_lens", [[0, 5, 17], [5, 17, 32]], ids=["0-5-17", "5-17-32"])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_attention_ref_matches_jax(page, sq, kv_lens, pages_per_step):
    rng = np.random.default_rng(page * 10 + sq)
    b, h, kh, d = 3, 4, 2, 16
    tables, n_pages = _tables(rng, kv_lens, page, width=32 // page + 1)
    q = _rand(rng, b, h, sq, d)
    k, v = _rand(rng, kh, n_pages, page, d), _rand(rng, kh, n_pages, page, d)
    kv_len = np.asarray(kv_lens, np.int32)
    want = jax_paged.paged_attention_ref(*map(jnp.asarray, (q, k, v, tables, kv_len)),
                                         pages_per_step=pages_per_step)
    got = paged.paged_attention_ref(*map(torch.from_numpy, (q, k, v, tables, kv_len)),
                                    pages_per_step=pages_per_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for i, n in enumerate(kv_lens):
        if n < sq:          # span rows before the first key: exactly 0
            assert not got[i, :, :sq - n].any()


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("fn", ["page_read", "page_read_blocked", "page_write",
                                "page_write_blocked"])
def test_page_gather_scatter_match_jax(fn, page):
    rng = np.random.default_rng(page)
    pool = _rand(rng, 128, 3, 2)
    table = (rng.permutation(128 // page)[:3] * page).astype(np.int32)
    if fn.startswith("page_read"):
        want = getattr(jax_paged, fn)(jnp.asarray(pool), jnp.asarray(table), page=page)
        got = getattr(paged, fn)(torch.from_numpy(pool), torch.from_numpy(table), page=page)
    else:
        rows = _rand(rng, 3 * page, 3, 2)
        want = getattr(jax_paged, fn)(jnp.asarray(pool), jnp.asarray(rows),
                                      jnp.asarray(table), page=page)
        target = torch.from_numpy(pool.copy())
        got = getattr(paged, fn)(target, torch.from_numpy(rows), torch.from_numpy(table),
                                 page=page)
        assert got is target                        # the port writes in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_takes_the_plain_version_on_cpu_and_refuses_int8():
    rng = np.random.default_rng(3)
    tables, n_pages = _tables(rng, [9, 3], 8, 2)
    q = torch.from_numpy(_rand(rng, 2, 4, 1, 64))
    k = torch.from_numpy(_rand(rng, 2, n_pages, 8, 64))
    kv_len = torch.tensor([9, 3], dtype=torch.int32)
    before = paged_ops.paged_attention.launches
    got = paged_ops.paged_attention(q, k, k, torch.from_numpy(tables), kv_len)
    assert torch.equal(got, paged.paged_attention_ref(q, k, k, torch.from_numpy(tables),
                                                      kv_len))
    assert paged_ops.paged_attention.launches == before
    with pytest.raises(NotImplementedError, match="int8"):
        paged_ops.paged_attention(q, k, k, torch.from_numpy(tables), kv_len, k_scale=k,
                                  v_scale=k)


def test_lm_decode_step_paged_matches_reference():
    """Reduced qwen1.5 (2 layers, f32) on the reference's params: three
    prompts prefilled, their K/V rows scattered into fused pools
    (L, 1, KH, n_pages, page, hd) through permuted tables, then one fused
    paged decode step at per-slot positions (slot 2 idle on the scratch
    page) through both models."""
    arch, page, max_len = "qwen1.5-0.5b", 8, 24
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert model.state_page_axes(model.init_decode_state(1, 4)) == {"k": 3, "v": 3}

    rng = np.random.default_rng(11)
    fills = [13, 6, 0]
    width = max_len // page
    tables, n_pages = _tables(rng, [n + 1 for n in fills], page, width)
    tables[2] = 0                                       # idle: all scratch
    pools = {n: np.zeros((cfg.n_layers, 1, cfg.n_kv_heads, n_pages, page, cfg.hd),
                         np.float32) for n in ("k", "v")}
    for i, n in enumerate(fills):
        if not n:
            continue
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        _, st = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
        for leaf in ("k", "v"):
            rows = np.asarray(st[leaf])[:, 0, :, :n]                # (L, KH, n, hd)
            for r in range(n):
                pools[leaf][:, 0, :, tables[i, r // page], r % page] = rows[:, :, r]
    tokens = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    pos = np.asarray(fills, np.int32)

    want_logits, _, want_pools = jmodel.decode_step_paged(
        jparams, {}, {n: jnp.asarray(p) for n, p in pools.items()}, jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(pos))
    got_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    got_logits, state, got_pools = model.decode_step_paged(
        params, {}, got_pools, torch.from_numpy(tables), torch.from_numpy(tokens),
        torch.from_numpy(pos))
    assert state == {}
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    for leaf in ("k", "v"):
        got, want = got_pools[leaf].numpy(), np.asarray(want_pools[leaf])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        changed = np.argwhere((got != pools[leaf]).any(axis=(0, 1, 2, 5)))
        written = {(int(tables[i, n // page]), n % page) for i, n in enumerate(fills)}
        assert {tuple(c) for c in changed} <= written
