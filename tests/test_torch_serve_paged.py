"""The port's paged ServeEngine against the JAX reference's, on qwen1.5-0.5b
--reduced with the reference's params and the same requests.

In every case the port's greedy ``report["outputs"]`` and the counters of
``report["paged"]`` must equal the reference engine's: fused decode off the
block table, the lane-activated fallback (``fused=False``, the bit-identical
oracle) and the contiguous lane-mode engine emit the same tokens through
mid-stream slot reuse; shared prefixes are prefilled once and shared
copy-on-write; a tight page budget spills and rehydrates, or preempts,
without changing a token. All requests arrive together, so both engines see
the same admission sequence regardless of host speed. Units check page-count
admission, the allocator and the store on their own."""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.serve import PagedConfig as JaxPagedConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import upd_page_defaults as jax_page_defaults
from repro_torch.configs import get_config
from repro_torch.nn.model import load_jax_params
from repro_torch.serve import (PageAllocator, PagedAdmission, PagedConfig, PagedKVStore,
                               PagesExhausted, Request, Scheduler, ServeEngine,
                               upd_page_defaults)
from repro_torch import tsl_api

ARCH = "qwen1.5-0.5b"
COUNTERS = ("prefix_hits", "prefix_misses", "cow_copies", "lane_activations",
            "tail_restores", "spills", "rehydrates", "preemptions",
            "resident_requests_peak")


def _requests(cls, vocab, gen_lens, prompt_len=8, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(gen_lens):
        toks = rng.integers(0, vocab, prompt_len).astype(np.int32)
        if prefix is not None:
            toks[:len(prefix)] = prefix
        out.append(cls(rid=f"r{i}", tokens=toks, gen_len=g,
                       shared_prefix_len=None if prefix is None else len(prefix)))
    return out


def _page_bytes(cfg, page):
    """Bytes of one page of the reduced model's K and V rows (f32)."""
    return page * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 4


def _pair(gen_lens, *, max_len=24, paged=None, prompt_len=8, seed=0, prefix=None):
    """(reference report, port report) on the same requests and params;
    ``paged`` None serves both in lane mode."""
    jax.clear_caches()
    jcfg = jax_get_config(ARCH).reduced()
    jeng = JaxServeEngine(jcfg, batch=2, max_len=max_len, seed=0,
                          paged=None if paged is None else JaxPagedConfig(**paged))
    jrep = jeng.run(_requests(JaxRequest, jcfg.vocab, gen_lens, prompt_len, seed, prefix))
    cfg = get_config(ARCH).reduced()
    params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = ServeEngine(cfg, batch=2, max_len=max_len, device="cpu", params=params,
                      paged=None if paged is None else PagedConfig(**paged))
    rep = eng.run(_requests(Request, cfg.vocab, gen_lens, prompt_len, seed, prefix))
    return jrep, rep


def _same_counters(jrep, rep):
    assert {k: rep["paged"][k] for k in COUNTERS} == \
        {k: jrep["paged"][k] for k in COUNTERS}


@pytest.fixture(scope="module")
def slot_reuse():
    """4 requests on 2 lanes: fused, lane fallback and contiguous, each
    through both engines."""
    gens = [5, 4, 4, 3]
    return {"fused": _pair(gens, paged={"fused": True}),
            "lane": _pair(gens, paged={"fused": False}),
            "contiguous": _pair(gens)}


def test_fused_equals_fallback_equals_contiguous(slot_reuse):
    fused, lane, contiguous = (slot_reuse[k][1] for k in ("fused", "lane", "contiguous"))
    assert fused["outputs"] == lane["outputs"] == contiguous["outputs"]
    assert sum(fused["slot_reuse"]) == 4 > 2                # slots reused mid-stream
    assert fused["paged"]["fused"] and not lane["paged"]["fused"]
    assert fused["paged"]["lane_activations"] == 0 < lane["paged"]["lane_activations"]
    assert fused["paged"]["tail_restores"] > 0
    assert fused["paged"]["gather_bytes_eliminated"] > 0
    assert fused["paged"]["resident_requests_peak"] > 2    # beyond the lane count
    assert fused["paged"]["hbm_bytes_resident"] == 0       # all freed at the end
    assert fused["paged"]["decode_steps"] > 0


@pytest.mark.parametrize("mode", ["fused", "lane", "contiguous"])
def test_outputs_and_counters_match_the_reference(slot_reuse, mode):
    jrep, rep = slot_reuse[mode]
    assert rep["outputs"] == jrep["outputs"]
    if mode != "contiguous":
        _same_counters(jrep, rep)
        assert rep["paged"]["fused"] == jrep["paged"]["fused"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "lane"])
def test_copy_on_write_shared_prefix(fused):
    """4 requests sharing a 16-token system prompt, page 16: one miss, three
    hits — the shared pages are prefilled once and read by every sharer."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, get_config(ARCH).reduced().vocab, 16).astype(np.int32)
    jrep, rep = _pair([3, 3, 3, 3], max_len=48, prompt_len=24, seed=8, prefix=system,
                      paged={"fused": fused, "page_size": 16})
    assert rep["outputs"] == jrep["outputs"]
    assert rep["paged"]["prefix_hits"] == 3
    assert rep["paged"]["prefix_misses"] == 1
    _same_counters(jrep, rep)
    # the publisher runs its whole bucket, each sharer skips the 16 shared rows
    chunk, bucket = rep["prefill_chunk"], rep["per_request"][0]["bucket"]
    assert sum(e["chunks"] for e in rep["step_log"]) == \
        bucket // chunk + 3 * ((bucket - 16) // chunk)


def test_spill_and_rehydrate_under_a_five_page_budget():
    cfg = get_config(ARCH).reduced()
    jrep, rep = _pair([4, 4, 4, 4, 4], seed=9, paged={
        "fused": True, "page_size": 8, "hbm_budget_bytes": 5 * _page_bytes(cfg, 8)})
    assert rep["outputs"] == jrep["outputs"]
    assert rep["paged"]["spills"] >= 1
    assert rep["paged"]["rehydrates"] >= 1
    assert rep["paged"]["host_spill_bytes"] == 0            # everything came back
    _same_counters(jrep, rep)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "lane"])
def test_preemption_returns_exact_tokens(fused):
    """gen 10 on prompt 8 grows each request from 1 page to 3 (page 8):
    admission prices the prompt, so growth exhausts the 5-page pool and
    preempts; the continuation re-prefills and emits the same tokens."""
    cfg = get_config(ARCH).reduced()
    jrep, rep = _pair([10, 10, 10], seed=5, paged={
        "fused": fused, "page_size": 8, "hbm_budget_bytes": 5 * _page_bytes(cfg, 8)})
    assert rep["outputs"] == jrep["outputs"]
    assert rep["paged"]["preemptions"] >= 1
    assert any(m["preemptions"] >= 1 for m in rep["per_request"])
    _same_counters(jrep, rep)


def test_int8_pages_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="int8"):
        PagedConfig(int8=True)


def test_page_serve_block_matches_the_reference():
    assert upd_page_defaults() == jax_page_defaults()


class FakeBudget:
    def __init__(self, free):
        self.free = free

    def pages_for_rows(self, rows):
        return -(-rows // 8) + 1            # data pages + a tail reservation

    def pages_free(self):
        return self.free


def test_paged_admission_defers_on_page_shortage():
    cfg = get_config(ARCH).reduced()
    budget = FakeBudget(free=100)
    adm = PagedAdmission(cfg, 2, 64, lib=tsl_api.lib("cpu"), budget=budget)
    ok, _ = adm.admit(Request(rid="a", tokens=np.zeros(16, np.int32), gen_len=4), 0.0)
    assert ok
    budget.free = 1                          # 16 rows need 2 + 1 pages
    req = Request(rid="b", tokens=np.zeros(16, np.int32), gen_len=4)
    ok, reason = adm.admit(req, 0.0)
    assert not ok and reason.startswith("defer")
    # a deferral stays at the FRONT of the queue; it is not a refusal
    sched = Scheduler(2, adm)
    sched.submit(req, 0.0)
    assert sched.next_admissible(0.0) is None
    assert sched.queue and sched.queue[0].rid == "b" and not sched.refused


def test_paged_admission_continuation_skips_sla_but_pays_pages():
    cfg = get_config(ARCH).reduced()
    budget = FakeBudget(free=100)
    adm = PagedAdmission(cfg, 2, 64, lib=tsl_api.lib("cpu"), budget=budget)
    cont = Request(rid="c", tokens=np.zeros(24, np.int32), gen_len=4, sla_s=1e-9,
                   resume_token=7)
    ok, _ = adm.admit(cont, 0.0)
    assert ok and cont.bucket >= 24
    budget.free = 0
    ok, reason = adm.admit(Request(rid="d", tokens=np.zeros(24, np.int32), gen_len=4,
                                   resume_token=7), 0.0)
    assert not ok and reason.startswith("defer")
    ok, reason = adm.admit(Request(rid="e", tokens=np.zeros(64, np.int32), gen_len=4,
                                   resume_token=7), 0.0)
    assert not ok and reason.startswith("over_budget")


def test_allocator_refcounts_and_double_free():
    alloc = PageAllocator(2)
    p = alloc.alloc()
    alloc.retain(p)
    alloc.release(p)
    assert alloc.refcount(p) == 1 and alloc.used_pages == 1
    alloc.release(p)
    with pytest.raises(ValueError):
        alloc.release(p)                    # double free
    with pytest.raises(ValueError):
        alloc.retain(p)                     # retain after free
    alloc.alloc(), alloc.alloc()
    with pytest.raises(PagesExhausted):
        alloc.alloc()


def _mini_store(**kw):
    import torch

    return PagedKVStore({"k": ((1, 32, 4), torch.float32)}, {"k": 1}, **kw)


@pytest.mark.parametrize("fused", [False, True], ids=["flat", "fused"])
def test_store_round_trip_and_copy_on_write(fused):
    """Rows round-trip bit-exactly through either pool layout; a sharer that
    writes into a published prefix page gets a fresh copy and the owner's
    rows stay as they were."""
    import torch

    store = _mini_store(page_size=8, n_pages=12, fused=fused,
                        ops=tsl_api.ops("cpu"))
    d1 = {"k": torch.randn(1, 32, 4, generator=torch.Generator().manual_seed(1))}
    store.attach("r1", prompt_rows=16)
    store.store_donor("r1", d1, fill=16)
    store.publish_prefix("r1", "shared", n_rows=16, tail=None)
    assert store.attach("r2", prompt_rows=16, share_key="shared") == 16
    assert store.requests["r1"].pages[:2] == store.requests["r2"].pages[:2]
    store.write_rows("r2", 8, 16, {"k": torch.full((8, 1, 4), 7.0)})
    assert store.cow_copies == 1
    assert store.requests["r1"].pages[1] != store.requests["r2"].pages[1]
    r1 = store.load_donor("r1", {"k": torch.zeros(1, 32, 4)})
    assert torch.equal(r1["k"][:, :16], d1["k"][:, :16])
    assert not r1["k"][:, 16:].any()
    r2 = store.load_donor("r2", {"k": torch.zeros(1, 32, 4)})
    assert torch.equal(r2["k"][:, 8:16], torch.full((1, 8, 4), 7.0))
    store.free("r1")
    store.free("r2")
    with pytest.raises(PagesExhausted):     # rollback: nothing leaks
        store.attach("big", prompt_rows=8 * 13)
    assert "big" not in store.requests
