"""The port's int8 page pools against the JAX reference's, on the same seeded
numpy inputs (reduced qwen1.5-0.5b for the layer, the model step and the
engine, with the reference's params carried across by ``load_jax_params``).

- (a) ``paged_attention_ref`` and the wrapper ``ops.paged_attention`` with
  int8 pools and their per-row float32 scales against
  ``repro.kernels.paged.ref.paged_attention_ref`` in float32 and bfloat16,
  head dim 64, spans of 1 and 5 rows. Tolerance: float32 1e-5 absolute +
  1e-5 relative (the same dequantized values, other summation orders);
  bfloat16 one bf16 rounding of the output, 2^-7 relative + 2^-7 absolute.
  The wrapper launches no kernel on int8 pools.
- (b) ``attention_span_paged`` with ``k_scale`` / ``v_scale`` against the
  reference's, one layer, a verify span of 3 rows per slot: after the write
  the int8 payloads are equal but for at most 1 % of the written elements,
  each off by one (a float32 product that lands on the other side of a
  rounding boundary), the scales within 1e-6 relative, every untouched row
  unchanged, and the layer's output within 1e-3 absolute + 1e-3 relative
  (int8 rows off by one move it by one quantization step). The model's
  fused decode and verify steps on int8 pools: logits within 1e-3 + 1e-3.
- (c) ``PagedKVStore(int8=True)``: dequantized rows within absmax / 254 of
  the rows written, in the flat and the fused layout; copy-on-write and
  spill / rehydrate keep payloads and scales bit-equal; one budget gives
  the reference's ``page_bytes`` and ``n_pages`` at full width.
- (d) ``ServeEngine`` with ``PagedConfig(int8=True)``, fused and lane, with
  and without speculation (``fixed_k=3``): greedy outputs and every counter
  of ``report["paged"]`` equal the reference engine's, ``int8`` true. All
  requests arrive at once, so both engines admit in the same order.
- (f) ``prefix_key`` differs with ``int8``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist.compression import quantize_absmax_int8 as jax_quantize
from repro.kernels.paged import ref as jax_paged
from repro.nn import attention as jax_attention
from repro.nn.model import build_model as jax_build_model
from repro.serve import PagedConfig as JaxPagedConfig
from repro.serve import PagedKVStore as JaxPagedKVStore
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpeculationConfig as JaxSpeculationConfig
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.kernels.paged import ops as paged_ops
from repro_torch.kernels.paged import ref as paged
from repro_torch.nn.attention import attention_span_paged
from repro_torch.nn.lm import unstack_layers
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (PagedConfig, PagedKVStore, Request, ServeEngine,
                               SpeculationConfig, prefix_key)

ARCH = "qwen1.5-0.5b"
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
COUNTERS = ("prefix_hits", "prefix_misses", "cow_copies", "lane_activations",
            "tail_restores", "spills", "rehydrates", "preemptions",
            "resident_requests_peak", "pages_used_peak", "n_pages", "page_bytes",
            "hbm_budget_bytes", "contiguous_resident_bound", "gather_bytes_eliminated",
            "int8", "fused")


def _int8_pools(rng, kh, n_pages, page, d):
    """An int8 payload pool and its (KH, n_pages, page, 1) float32 scales."""
    q8 = rng.integers(-127, 128, (kh, n_pages, page, d)).astype(np.int8)
    return q8, rng.uniform(0.005, 0.02, (kh, n_pages, page, 1)).astype(np.float32)


# -- (a) the plain version and the wrapper --------------------------------------


@pytest.mark.parametrize("via", ["ref", "wrapper"])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_attention_matches_the_reference(dtype, sq, via):
    rng = np.random.default_rng(sq * 7 + (dtype == "bfloat16"))
    b, h, kh, d, page, width = 3, 4, 2, 64, 8, 4
    kv_lens = np.asarray([0, 11, 27], np.int32) + sq
    n_pages = 1 + b * width
    tables = (1 + rng.permutation(n_pages - 1)).reshape(b, width).astype(np.int32)
    q = rng.uniform(-1, 1, (b, h, sq, d)).astype(np.float32)
    k8, ks = _int8_pools(rng, kh, n_pages, page, d)
    v8, vs = _int8_pools(rng, kh, n_pages, page, d)
    jq = jnp.asarray(q, getattr(jnp, dtype))
    want = jax_paged.paged_attention_ref(
        jq, *map(jnp.asarray, (k8, v8, tables, kv_lens)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    fn = paged.paged_attention_ref if via == "ref" else paged_ops.paged_attention
    before = paged_ops.paged_attention.launches
    got = fn(tq, *map(torch.from_numpy, (k8, v8, tables, kv_lens)),
             k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert paged_ops.paged_attention.launches == before
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# -- (b) the layer's span write and the model steps -----------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _span_inputs(cfg, seed, *, layers=None, span=3):
    """Int8 pools written with seeded rows, tables over a permutation of the
    pages (slot 2 idle on the scratch page 0), per-slot positions and span
    activations / tokens."""
    rng = np.random.default_rng(seed)
    page, width, b = 8, 4, 3
    n_pages = 1 + b * width
    lead = () if layers is None else (layers, 1)
    shape = lead + (cfg.n_kv_heads, n_pages, page, cfg.hd)
    pools = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in ("k", "v")}
    pools.update({f"{n}__scale": rng.uniform(0.005, 0.02, shape[:-1] + (1,))
                  .astype(np.float32) for n in ("k", "v")})
    tables = (1 + rng.permutation(n_pages - 1)).reshape(b, width).astype(np.int32)
    tables[2] = 0
    pos = np.asarray([13, 6, 0], np.int32)
    x = rng.normal(size=(b, span, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, span)).astype(np.int32)
    return pools, tables, pos, x, tokens


def _written(tables, pos, span, page):
    """{(page id, offset)} of the rows a span writes (idle slot 2 included:
    its rows land on the scratch page)."""
    return {(int(tables[i, (p + j) // page]), (p + j) % page)
            for i, p in enumerate(pos) for j in range(span)}


def _check_int8_pool(got, want, before, written, *, scale):
    """Payloads equal but for <= 1 % off by one, scales within 1e-6
    relative; rows outside ``written`` unchanged. Pools (..., n_pages, page,
    last)."""
    got, want = np.asarray(got), np.asarray(want)
    if scale:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        n_written = len(written) * int(np.prod(got.shape[:-3])) * got.shape[-1]
        assert (diff > 0).sum() <= 0.01 * n_written
    lead = got.ndim - 3
    changed = np.argwhere((got != before).any(axis=tuple(range(lead)) + (got.ndim - 1,)))
    assert {tuple(int(i) for i in c) for c in changed} <= written


def test_attention_span_paged_writes_and_reads_int8_pools(models):
    jcfg, jmodel, jparams, cfg, model, params = models
    pools, tables, pos, x, _ = _span_inputs(cfg, seed=21)
    span, page = x.shape[1], pools["k"].shape[-2]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    want = jax_attention.attention_span_paged(
        jp, jnp.asarray(x), *(jnp.asarray(pools[n]) for n in ("k", "v")),
        jnp.asarray(tables), jnp.asarray(pos), jcfg,
        jax_attention.tsl.attention_verify_paged,
        k_scale=jnp.asarray(pools["k__scale"]), v_scale=jnp.asarray(pools["v__scale"]))
    got_pools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    p = unstack_layers(params["blocks"], cfg.n_layers)[0]["attn"]
    tpos = torch.from_numpy(pos)
    y, _, _ = attention_span_paged(
        model.tsl, p, torch.from_numpy(x), got_pools["k"], got_pools["v"],
        torch.from_numpy(tables), tpos, cfg, model.tsl.attention_verify_paged,
        kv_len=(tpos + span).to(torch.int32), k_scale=got_pools["k__scale"],
        v_scale=got_pools["v__scale"])
    written = _written(tables, pos, span, page)
    for i, n in enumerate(("k", "v", "k__scale", "v__scale")):
        _check_int8_pool(got_pools[n].numpy(), want[1 + i], pools[n], written,
                         scale=n.endswith("scale"))
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=1e-3, rtol=1e-3)


def test_quantized_row_equals_the_reference_wire_format():
    """The rows the span writes are the wire format's: the port's
    quantize_absmax_int8 against the reference's on the same rows."""
    from repro_torch.dist.compression import quantize_absmax_int8

    x = np.random.default_rng(4).normal(size=(2, 3, 5, 64)).astype(np.float32)
    q, s = quantize_absmax_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_model_paged_steps_on_int8_pools_match_the_reference(models, kind):
    jcfg, jmodel, jparams, cfg, model, params = models
    span = 1 if kind == "decode" else 3
    pools, tables, pos, _, tokens = _span_inputs(cfg, seed=31, layers=cfg.n_layers,
                                                 span=span)
    jfn = jmodel.decode_step_paged if kind == "decode" else jmodel.verify_step_paged
    fn = model.decode_step_paged if kind == "decode" else model.verify_step_paged
    want_logits, _, want_pools = jfn(jparams, {}, {n: jnp.asarray(a) for n, a in pools.items()},
                                     jnp.asarray(tables), jnp.asarray(tokens),
                                     jnp.asarray(pos))
    got_pools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    logits, _, out = fn(params, {}, got_pools, torch.from_numpy(tables),
                        torch.from_numpy(tokens), torch.from_numpy(pos))
    assert all(out[n] is got_pools[n] for n in got_pools)       # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-3,
                               rtol=1e-3)
    written = _written(tables, pos, span, pools["k"].shape[-2])
    for n in pools:
        _check_int8_pool(got_pools[n].numpy(), want_pools[n], pools[n], written,
                         scale=n.endswith("scale"))


# -- (c) the store --------------------------------------------------------------


def _store(fused, n_pages=8, **kw):
    return PagedKVStore({"k": ((1, 2, 32, 8), torch.float32)}, {"k": 2}, page_size=8,
                        n_pages=n_pages, int8=True, fused=fused, ops=tsl_api.ops("cpu"),
                        device="cpu", **kw)


def _donor(seed):
    return {"k": torch.from_numpy(np.random.default_rng(seed).normal(size=(1, 2, 32, 8))
                                  .astype(np.float32))}


@pytest.mark.parametrize("fused", [False, True], ids=["flat", "fused"])
def test_int8_store_honours_the_absmax_bound(fused):
    store = _store(fused)
    donor = _donor(3)
    store.attach("a", prompt_rows=24)
    store.store_donor("a", donor, fill=24)
    assert store.pools["k"].dtype == torch.int8
    out = store.load_donor("a", {"k": torch.zeros(1, 2, 32, 8)})
    x, y = donor["k"][:, :, :24].numpy(), out["k"][:, :, :24].numpy()
    bound = np.abs(x).max(-1, keepdims=True) / 254 + 1e-7
    assert (np.abs(x - y) <= bound).all()
    assert not out["k"][:, :, 24:].any()
    if fused:
        # the fused pool read through the request's table row dequantizes to
        # the same rows, which is what the paged primitive reads
        tab = torch.from_numpy(store.table_row("a", 3)).long()
        q = store.pools["k"][0][:, tab].reshape(2, 24, 8).float()
        s = store.scale_pools["k"][0][:, tab].reshape(2, 24, 1)
        assert torch.equal(q * s, out["k"][0, :, :24])


def _page_rows(store, pid):
    """Payload and scale rows of page ``pid``, either layout."""
    return [store._pool_gather(pool, ax, [pid]).clone() for _, pool, ax in
            store._all_pools()]


@pytest.mark.parametrize("fused", [False, True], ids=["flat", "fused"])
def test_int8_copy_on_write_and_spill_keep_payload_and_scales(fused):
    store = _store(fused, n_pages=12)
    store.attach("a", prompt_rows=24)
    store.store_donor("a", _donor(5), fill=24)
    store.publish_prefix("a", "shared", n_rows=16, tail=None)
    assert store.attach("b", prompt_rows=24, share_key="shared") == 16
    sp = store.requests["b"]
    shared = sp.pages[1]
    before = _page_rows(store, shared)
    store._cow(sp, 1, 2)
    assert store.cow_copies == 1 and sp.pages[1] != shared
    for old, new in zip(before, _page_rows(store, sp.pages[1])):
        assert torch.equal(old, new)
    # spill a's exclusive last page to the host and rehydrate it
    store.unpin("a")
    last = store.requests["a"].pages[-1]
    rows = _page_rows(store, last)
    assert store._spill_one() and store.spills == 1
    assert set(store._spilled["a"][2]) == {"k", "k__scale"}
    store.pin("a")
    assert store.rehydrates == 1
    for old, new in zip(rows, _page_rows(store, store.requests["a"].pages[-1])):
        assert torch.equal(old, new)


@pytest.mark.parametrize("int8", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["flat", "fused"])
def test_one_budget_gives_the_reference_pages(fused, int8):
    """Small KV leaves (2 layers, 2 KV heads of 16, bf16) under one budget:
    row and page bytes and the page count equal the reference store's."""
    shape, axes, budget = (2, 1, 2, 40, 16), {"k": 3, "v": 3}, 100_000
    ref = JaxPagedKVStore({n: jax.ShapeDtypeStruct(shape, jnp.bfloat16) for n in axes},
                          axes, page_size=8, hbm_budget_bytes=budget, int8=int8,
                          fused=fused)
    port = PagedKVStore({n: (shape, torch.bfloat16) for n in axes}, axes, page_size=8,
                        hbm_budget_bytes=budget, int8=int8, fused=fused, ops=None,
                        device="cpu")
    assert (port.row_bytes, port.page_bytes, port.n_pages) == \
        (ref.row_bytes, ref.page_bytes, ref.n_pages)
    assert port.contiguous_bytes_per_slot(40) == ref.contiguous_bytes_per_slot(40)
    for n in axes:
        assert tuple(port.pools[n].shape) == tuple(ref.pools[n].shape)
        if int8:
            assert tuple(port.scale_pools[n].shape) == tuple(ref.scale_pools[n].shape)


def test_full_width_budget_holds_1_88_times_the_pages():
    """Full-width qwen1.5 KV leaves (24 layers, 16 KV heads of 64, bf16):
    an int8 row costs 24 x 2 x 16 x (64 + 4) = 52224 bytes against 98304,
    so the budget of 80 bf16 pages of 64 holds 150 int8 pages. The port
    prices the layout on the meta device; the reference's page bytes come
    from a one-page store of each precision."""
    cfg = get_config(ARCH)
    shape, axes = (cfg.n_layers, 1, cfg.n_kv_heads, 320, cfg.hd), {"k": 3, "v": 3}
    budget = 80 * 64 * 98304
    stores = {int8: PagedKVStore({n: (shape, torch.bfloat16) for n in axes}, axes,
                                 page_size=64, hbm_budget_bytes=budget, int8=int8,
                                 fused=True, ops=None, device="meta")
              for int8 in (False, True)}
    for int8, st in stores.items():
        ref = JaxPagedKVStore({n: jax.ShapeDtypeStruct(shape, jnp.bfloat16) for n in axes},
                              axes, page_size=64, n_pages=1, int8=int8, fused=True)
        assert st.page_bytes == ref.page_bytes
    assert stores[True].row_bytes == 52224 and stores[False].row_bytes == 98304
    assert (stores[False].n_pages, stores[True].n_pages) == (80, 150)


# -- (d) the engine ---------------------------------------------------------------


def _requests(cls, vocab, gen_lens=(5, 4, 4, 3), prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=f"r{i}", tokens=rng.integers(0, vocab, prompt_len).astype(np.int32),
                gen_len=g) for i, g in enumerate(gen_lens)]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "fixed_k3"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "lane"])
def test_int8_engine_matches_the_reference(fused, spec):
    jax.clear_caches()
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jspec = {"speculation": JaxSpeculationConfig(fixed_k=3)} if spec else {}
    jeng = JaxServeEngine(jcfg, batch=2, max_len=24, seed=0,
                          paged=JaxPagedConfig(int8=True, fused=fused), **jspec)
    jrep = jeng.run(_requests(JaxRequest, jcfg.vocab))
    params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    kw = {"speculation": SpeculationConfig(fixed_k=3)} if spec else {}
    rep = ServeEngine(cfg, batch=2, max_len=24, device="cpu", params=params,
                      paged=PagedConfig(int8=True, fused=fused), **kw).run(
        _requests(Request, cfg.vocab))
    assert rep["outputs"] == jrep["outputs"]
    assert {k: rep["paged"][k] for k in COUNTERS} == {k: jrep["paged"][k] for k in COUNTERS}
    assert rep["paged"]["int8"] is True and rep["paged"]["fused"] is fused
    assert rep["paged"]["hbm_bytes_resident"] == 0
    if spec:
        assert rep["spec"]["verify_steps"] == jrep["spec"]["verify_steps"] > 0
        assert rep["spec"]["accepted_tokens"] == jrep["spec"]["accepted_tokens"]


# -- (f) the prefix key -------------------------------------------------------------


def test_prefix_key_hashes_the_precision():
    base = dict(arch=ARCH, page_size=64, int8=False, seed=0, tokens=[1, 2, 3])
    assert prefix_key(**base) == prefix_key(**base)
    assert prefix_key(**base) != prefix_key(**{**base, "int8": True})
    assert prefix_key(**base) != prefix_key(**{**base, "tokens": [1, 2, 4]})
