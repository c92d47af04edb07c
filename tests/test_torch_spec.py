"""The port's speculative decoding against the JAX reference's, on reduced
qwen1.5-0.5b (4 heads, MHA) and qwen3-14b (4 heads over 2 KV heads) with the
reference's params carried across by ``load_jax_params``.

- The acceptance rule and the n-gram drafter equal the reference's on
  hypothesis-drawn inputs; the prefix and full-acceptance properties hold.
- The cost-priced policy chooses the reference's depths (the port prices
  against its SRU's bandwidth, the reference against its own, so the verify
  price is held to the reference's as a ratio to the decode step).
- ``Model.verify_step`` / ``verify_step_paged``: logits and written cache
  rows against ``lm_verify_step`` / ``lm_verify_step_paged`` under the
  reduced-model gate (``gates.GATES["model_f32"]``).
- The engine, lane mode and fused paged mode, ``fixed_k=3`` and the priced
  policy: greedy outputs equal the reference's speculative engine and the
  port's plain engine, token for token, and every speculation counter
  equals the reference's. ``fixed_k=0`` is the plain engine (sampled
  requests included); an oracle drafter accepts every draft; the draft-model
  drafter proposes the reference's drafts; page 4 with ``fixed_k=4`` (spans
  crossing pages, idle slots and shallower neighbours on scratch entries)
  equals lane mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro.serve import NGramDrafter as JaxNGramDrafter
from repro.serve import PagedConfig as JaxPagedConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpeculationConfig as JaxSpeculationConfig
from repro.serve import SpeculationPolicy as JaxSpeculationPolicy
from repro.serve import accept_span as jax_accept_span
from repro.serve import upd_verify_defaults as jax_verify_defaults
from repro.serve.scheduler import CostModelAdmission as JaxAdmission
from repro_torch import gates, tsl_api
from repro_torch.configs import get_config
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (CostModelAdmission, NGramDrafter, PagedConfig, Request,
                               SamplingConfig, ServeEngine, SpeculationConfig,
                               SpeculationPolicy, accept_span, assert_span_fits,
                               upd_verify_defaults)

ARCHS = ("qwen1.5-0.5b", "qwen3-14b")
BATCH, MAX_LEN = 2, 48
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
SPEC_COUNTERS = ("decode_steps", "verify_steps", "drafted_tokens", "accepted_tokens",
                 "accept_by_bucket")
PER_REQUEST = ("tokens_out", "spec_proposed", "spec_accepted", "verify_rounds")


def _requests(cls, vocab, *, sampled=False):
    """The reference test's three requests over a 2-slot table: a
    multi-chunk repetitive prompt, a random one, and a third that waits for a
    freed slot (mid-stream slot reuse)."""
    rnd = np.random.default_rng(0).integers(1, vocab, 5)
    reqs = [cls(rid="a", tokens=np.array(REPETITIVE), gen_len=9),
            cls(rid="b", tokens=rnd, gen_len=6),
            cls(rid="c", tokens=np.array(REPETITIVE[:7]), gen_len=8)]
    if sampled:
        reqs[1].temperature = 0.9           # one sampled slot amid greedy
    return reqs


# -- the acceptance rule and the n-gram drafter --------------------------------


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 6), st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
def test_accept_span_equals_the_reference_and_is_a_prefix(k, b, seed):
    rng = np.random.default_rng(seed)
    drafts = rng.integers(0, 4, (b, k))         # a tiny alphabet: real matches
    target = rng.integers(0, 4, (b, k + 1))
    window = rng.integers(-1, k + 3, b)
    m = accept_span(drafts, target, window)
    np.testing.assert_array_equal(m, np.asarray(jax_accept_span(drafts, target, window)))
    for i in range(b):
        mi = int(m[i])
        assert 0 <= mi <= max(min(window[i], k), 0)
        assert (drafts[i, :mi] == target[i, :mi]).all()
        if mi < min(window[i], k):                  # stopped at a mismatch
            assert drafts[i, mi] != target[i, mi]


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
def test_accept_span_accepts_the_whole_window_when_drafts_are_the_target(k, b, seed):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 50, (b, k + 1))
    window = rng.integers(0, k + 1, b)
    assert (accept_span(target[:, :k], target, window) == np.minimum(window, k)).all()
    with pytest.raises(ValueError, match="K\\+1"):
        accept_span(target[:, :k], target[:, :k], window)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.lists(st.integers(0, 5), min_size=1, max_size=24), min_size=1,
                max_size=4),
       st.integers(1, 5), st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
def test_ngram_propose_equals_the_reference(hists, K, max_ngram, seed):
    """Prompt lookup over small-alphabet histories (recurring n-grams): the
    same drafts per slot, zeros for idle or depth-0 slots."""
    rng = np.random.default_rng(seed)
    batch = len(hists) + 1                          # the last slot stays idle
    histories = dict(enumerate(hists))
    active = list(histories)
    k_vec = rng.integers(0, K + 1, batch)
    got = NGramDrafter(max_ngram).propose(active, histories, k_vec, batch, K)
    want = JaxNGramDrafter(max_ngram).propose(active, histories, k_vec, batch, K)
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()


def test_ngram_drafter_prompt_lookup():
    d = NGramDrafter(max_ngram=3)
    hist = np.array([5, 7, 8, 9, 1, 2, 7, 8])       # [7, 8] recurs, then [9, 1]
    assert d._continue(hist, 2) == [9, 1]
    assert d._continue(hist, 4) == [9, 1, 2, 7]
    assert d._continue(np.array([1, 2, 3]), 3) == [3, 3, 3]   # no recurrence
    assert d.cost_per_token_s() == 0.0


# -- the UPD span bound and the priced depth -----------------------------------


def test_k_max_comes_from_the_ports_corpus():
    assert upd_verify_defaults() == jax_verify_defaults() == {"k_max": 4}
    cfg = get_config("qwen1.5-0.5b").reduced()
    eng = ServeEngine(cfg, batch=2, max_len=MAX_LEN, device="cpu",
                      speculation=SpeculationConfig())
    assert eng._k_max == 4 and eng._state_len == MAX_LEN + 4
    assert eng.cost_model.spec_k == 4


def test_k_max_missing_from_the_corpus_raises(monkeypatch):
    import repro_torch.core as core

    class _Corpus:
        primitives = {}

    monkeypatch.setattr(core, "load_corpus", lambda: _Corpus())
    with pytest.raises(ValueError, match="k_max"):
        upd_verify_defaults()


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_chooses_the_references_depths(arch):
    """Over a grid of acceptance EMA, fill and remaining budget the priced
    depth equals the reference's; the verify price per decode step, at every
    depth and fill, equals the reference's to 1e-12."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    ours = CostModelAdmission(cfg, BATCH, MAX_LEN, lib=tsl_api.lib("cpu"))
    ref = JaxAdmission(jcfg, batch=BATCH, max_len=MAX_LEN)
    for s in (None, 1, 17, 48):
        for k in range(5):
            assert ours.verify_seconds(k, s) / ours.step_seconds() == pytest.approx(
                ref.verify_seconds(k, s) / ref.step_seconds(), rel=1e-12)
    ours.spec_k = ref.spec_k = 4
    assert ours.emit_seconds_per_token(20) / ours.step_seconds() == pytest.approx(
        ref.emit_seconds_per_token(20) / ref.step_seconds(), rel=1e-12)
    alphas = (0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8, 0.95, 1.0)
    got = SpeculationPolicy(len(alphas), 4, ours, SpeculationConfig())
    want = JaxSpeculationPolicy(len(alphas), 4, ref, JaxSpeculationConfig())
    got.alpha[:] = want.alpha[:] = alphas
    depths = []
    for slot in range(len(alphas)):
        for fill in (0, 5, 20, 40, 47):
            for remaining in (0, 1, 2, 3, 5, 9):
                d = got.depth(slot, fill, remaining)
                assert d == want.depth(slot, fill, remaining), (slot, fill, remaining)
                depths.append(d)
    assert 0 in depths and max(depths) == 4     # the grid reaches both ends
    fixed = SpeculationPolicy(2, 4, ours, SpeculationConfig(fixed_k=3))
    assert fixed.depth(0, 10, 10) == 3 and fixed.depth(0, 10, 3) == 2
    got.update(0, proposed=4, accepted=2)
    want.update(0, proposed=4, accepted=2)
    assert got.alpha[0] == want.alpha[0]


def test_scheduler_carries_the_references_speculation_accounting():
    from dataclasses import fields

    from repro.serve.scheduler import RequestMetrics as JaxMetrics
    from repro_torch.serve import RequestMetrics, Scheduler

    assert [f.name for f in fields(RequestMetrics)] == [f.name for f in fields(JaxMetrics)]
    sched = Scheduler(1)
    req = Request(rid="q", tokens=np.zeros(4, np.int32), gen_len=9)
    sched.submit(req, 0.0)
    sched.reserve(0, sched.next_admissible(0.0), step=0)
    sched.place(req, 0)
    sched.first_token(0, 0.1)
    sched.step_done(0, n=3)
    sched.spec_round(0, proposed=4, accepted=2)
    m = sched.slots[0].metrics
    assert (m.tokens_out, m.spec_proposed, m.spec_accepted, m.verify_rounds) == (4, 4, 2, 1)


def test_assert_span_fits_raises_on_an_overrun():
    assert_span_fits(np.array([0, 43]), 5, 48)
    assert_span_fits(np.array([], np.int64), 5, 48)
    with pytest.raises(RuntimeError, match="overruns"):
        assert_span_fits(np.array([0, 44]), 5, 48)


# -- the verify steps against lm_verify_step / lm_verify_step_paged ------------


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    arch = request.param
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params, cfg


def _gate(got, want, name):
    gates.check(torch.tensor(np.asarray(got, np.float32)),
                torch.tensor(np.asarray(want, np.float32)), "model_f32", name)


def test_verify_step_matches_lm_verify_step(model_pair):
    """Two prefills grafted into slots 1 and 0, slot 2 idle: a span of 4 at
    a (B,) vector of per-slot base rows; the logits of every row and every
    cache row written."""
    jmodel, jparams, model, params, cfg = model_pair
    max_len, sv = 20, 4
    jstate = jmodel.init_decode_state(3, max_len)
    state = model.init_decode_state(3, max_len)
    rng = np.random.default_rng(21)
    for slot, n in {1: 9, 0: 5}.items():
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        _, jd = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
        _, td = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len)
        jstate = jmodel.insert_slot(jstate, jd, slot)
        state = model.insert_slot(state, td, slot)
    pos = np.asarray([5, 9, 0], np.int32)
    span = rng.integers(0, cfg.vocab, (3, sv)).astype(np.int32)
    jl, jstate = jmodel.verify_step(jparams, jstate, jnp.asarray(span), jnp.asarray(pos))
    tl, state = model.verify_step(params, state, torch.from_numpy(span),
                                  torch.from_numpy(pos))
    assert tuple(tl.shape) == (3, sv, cfg.padded_vocab)
    _gate(tl, jl, "verify logits")
    for leaf in ("k", "v"):
        _gate(state[leaf], jstate[leaf], f"verify cache {leaf}")
        assert not state[leaf][:, 2, :, sv:].any()      # the idle slot: its span only
    # row 0 of a span is the decode step at the same position
    dl, _ = model.decode_step(params, model.init_decode_state(3, max_len),
                              torch.from_numpy(span[:, :1]), torch.zeros(3, dtype=torch.long))
    _gate(tl[2, 0], dl[2], "span row 0 vs decode")


def test_verify_step_paged_matches_lm_verify_step_paged(model_pair):
    """Fused pools behind permuted tables at page 4: a span of 5 at per-slot
    positions crosses page boundaries, slot 2 idle on an all-scratch row.
    The logits of every row and the pools after the step; only the span's
    rows (and the scratch page) change."""
    jmodel, jparams, model, params, cfg = model_pair
    page, width, sv = 4, 5, 5
    rng = np.random.default_rng(23)
    fills = [6, 11, 0]
    n_pages = 1 + 2 * width
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((3, width), np.int32)
    tables[0], tables[1] = perm[:width], perm[width:2 * width]
    pools = {n: rng.uniform(-1, 1, (cfg.n_layers, 1, cfg.n_kv_heads, n_pages, page,
                                    cfg.hd)).astype(np.float32) for n in ("k", "v")}
    span = rng.integers(0, cfg.vocab, (3, sv)).astype(np.int32)
    pos = np.asarray(fills, np.int32)
    want_logits, _, want_pools = jmodel.verify_step_paged(
        jparams, {}, {n: jnp.asarray(p) for n, p in pools.items()}, jnp.asarray(tables),
        jnp.asarray(span), jnp.asarray(pos))
    got_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    got_logits, state, got_pools = model.verify_step_paged(
        params, {}, got_pools, torch.from_numpy(tables), torch.from_numpy(span),
        torch.from_numpy(pos))
    assert state == {} and tuple(got_logits.shape) == (3, sv, cfg.padded_vocab)
    _gate(got_logits, want_logits, "paged verify logits")
    written = {(int(tables[i, (f + r) // page]), (f + r) % page)
               for i, f in enumerate(fills) for r in range(sv)}
    for leaf in ("k", "v"):
        got = got_pools[leaf].numpy()
        _gate(got, want_pools[leaf], f"paged verify pool {leaf}")
        changed = np.argwhere((got != pools[leaf]).any(axis=(0, 1, 2, 5)))
        assert {tuple(c) for c in changed} <= written


# -- the engine against the reference's ----------------------------------------


def _spec(kind, cls):
    return cls(fixed_k=3) if kind == "fixed_k3" else cls()


@pytest.fixture(scope="module")
def engine_runs():
    """(reference report, port report, port plain report) per (arch, mode,
    policy), built on first use; the port serves the reference's params."""
    cache = {}

    def run(arch, mode, kind):
        key = (arch, mode, kind)
        if key not in cache:
            jax.clear_caches()
            jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
            jkw = {"paged": JaxPagedConfig()} if mode == "fused" else {}
            kw = {"paged": PagedConfig()} if mode == "fused" else {}
            jeng = JaxServeEngine(jcfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                                  speculation=_spec(kind, JaxSpeculationConfig), **jkw)
            jrep = jeng.run(_requests(JaxRequest, jcfg.vocab))
            params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
            rep = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                              params=params, speculation=_spec(kind, SpeculationConfig),
                              **kw).run(_requests(Request, cfg.vocab))
            plain = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                                params=params, **kw).run(_requests(Request, cfg.vocab))
            cache[key] = (jrep, rep, plain)
        return cache[key]

    return run


@pytest.mark.parametrize("kind", ["fixed_k3", "priced"])
@pytest.mark.parametrize("mode", ["lane", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_the_reference_and_plain_decode(engine_runs, arch, mode, kind):
    jrep, rep, plain = engine_runs(arch, mode, kind)
    assert rep["outputs"] == jrep["outputs"] == plain["outputs"]
    assert rep["spec"]["verify_steps"] > 0
    assert {k: rep["spec"][k] for k in SPEC_COUNTERS} == \
        {k: jrep["spec"][k] for k in SPEC_COUNTERS}
    for k in ("accepted_rate", "mean_accepted_span", "steps_per_emitted_token",
              "slot_steps_per_emitted_token"):
        assert rep["spec"][k] == pytest.approx(jrep["spec"][k], rel=1e-12)
    assert rep["spec"]["drafter"] == "ngram" and rep["spec"]["k_max"] == 4

    def per_request(r):
        return {m["rid"]: tuple(m[k] for k in PER_REQUEST) for m in r["per_request"]}

    assert per_request(rep) == per_request(jrep)
    for m in rep["per_request"]:
        assert m["tokens_out"] == len(rep["outputs"][m["rid"]])
    assert sum(rep["slot_reuse"]) == 3                      # a slot was reused
    assert rep["cost_model"]["verify_seconds_k_max"] > 0
    if mode == "fused":
        assert rep["paged"]["fused"] and not rep["paged"]["lane_activations"]
        assert rep["paged"]["verify_steps"] == rep["spec"]["verify_steps"]
        assert rep["paged"]["hbm_bytes_resident"] == 0      # every page freed


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_k0_is_the_plain_engine_sampled_requests_included(mode):
    """fixed_k=0 runs the plain decode call and the same sampler draws:
    identical outputs to the plain engine with one sampled request."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    kw = {"paged": PagedConfig()} if mode == "fused" else {}

    def run(**extra):
        return ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu", seed=0,
                           sampling=SamplingConfig(top_k=20), **kw, **extra).run(
            _requests(Request, cfg.vocab, sampled=True))

    plain = run()
    spec = run(speculation=SpeculationConfig(fixed_k=0))
    assert spec["outputs"] == plain["outputs"]
    assert spec["spec"]["verify_steps"] == 0 and spec["spec"]["decode_steps"] > 0
    assert spec["spec"]["slot_steps_per_emitted_token"] == 1.0
    # the sampled request really drew (greedy would repeat its own prefix)
    greedy = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu", seed=0,
                         **kw).run(_requests(Request, cfg.vocab))
    assert spec["outputs"]["b"] != greedy["outputs"]["b"]


class _OracleDrafter:
    """Replays the plain engine's greedy outputs as drafts: drafter ==
    target, so every in-window draft must be accepted."""

    def __init__(self, outputs, prompt_lens):
        self.outputs, self.prompt_lens, self.slot_rid = outputs, prompt_lens, {}

    def cost_per_token_s(self):
        return 0.0

    def on_chunk(self, rid, seg, n_real):
        pass

    def on_graft(self, rid, slot, history):
        self.slot_rid[slot] = rid

    def on_commit(self, slot, m):
        pass

    def on_finish(self, slot):
        pass

    def propose(self, active, histories, k_vec, batch, K):
        drafts = np.zeros((batch, K), np.int64)
        for slot in active:
            rid = self.slot_rid[slot]
            done = len(histories[slot]) - self.prompt_lens[rid]
            fut = list(self.outputs[rid][done:done + K])
            drafts[slot, :] = fut + [0] * (K - len(fut))
        return drafts


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_oracle_drafter_fully_accepts(mode):
    cfg = get_config("qwen1.5-0.5b").reduced()
    kw = {"paged": PagedConfig()} if mode == "fused" else {}
    plain = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                        **kw).run(_requests(Request, cfg.vocab))
    eng = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                      speculation=SpeculationConfig(fixed_k=3), **kw)
    eng._drafter = _OracleDrafter(plain["outputs"], {r.rid: r.prompt_len for r in
                                                     _requests(Request, cfg.vocab)})
    rep = eng.run(_requests(Request, cfg.vocab))
    assert rep["outputs"] == plain["outputs"]
    assert rep["spec"]["accepted_rate"] == 1.0
    assert rep["spec"]["slot_steps_per_emitted_token"] < 0.5
    for stats in rep["spec"]["accept_by_bucket"].values():
        assert stats["accepted_rate"] == 1.0 and stats["mean_accepted_span"] > 1.0


def _recording(drafter, log):
    propose = drafter.propose

    def wrapped(*args):
        drafts = propose(*args)
        log.append(np.array(drafts))
        return drafts

    drafter.propose = wrapped


def test_draft_model_drafter_proposes_the_references_drafts():
    """drafter="draft_model", draft_arch="qwen1.5-0.5b": the port's draft
    model runs the reference drafter's params; every round's drafts, the
    outputs and the counters equal the reference's."""
    arch = "qwen1.5-0.5b"
    jax.clear_caches()
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jspec = JaxSpeculationConfig(drafter="draft_model", draft_arch=arch, fixed_k=4)
    jeng = JaxServeEngine(jcfg, batch=BATCH, max_len=MAX_LEN, seed=0, speculation=jspec)
    jlog, log = [], []
    _recording(jeng._drafter, jlog)
    jrep = jeng.run(_requests(JaxRequest, jcfg.vocab))
    eng = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                      params=load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                             "cpu"),
                      speculation=SpeculationConfig(drafter="draft_model", draft_arch=arch,
                                                    fixed_k=4),
                      draft_params=load_jax_params(
                          jax.tree.map(np.asarray, jeng._drafter.params), cfg, "cpu"))
    drafter = eng._drafter
    assert drafter.cfg == cfg                               # the reduced arch
    assert drafter.state["k"].shape[3] == MAX_LEN + 4       # state_len rows
    _recording(drafter, log)
    rep = eng.run(_requests(Request, cfg.vocab))
    assert len(log) == len(jlog) > 0
    for got, want in zip(log, jlog):
        np.testing.assert_array_equal(got, want)
    assert rep["outputs"] == jrep["outputs"]
    assert {k: rep["spec"][k] for k in SPEC_COUNTERS} == \
        {k: jrep["spec"][k] for k in SPEC_COUNTERS}
    assert rep["spec"]["drafter"] == "draft_model"
    assert drafter.cost_per_token_s() > 0


def test_fused_page_4_depth_4_equals_lane_mode():
    """Spans of 5 rows on pages of 4: every verify span crosses a page, the
    idle slot's span (position 0, all-scratch row) reaches table entry 1,
    and a slot clipped below the step's depth writes its neighbours' extra
    rows past its grown pages. All of them must land on the slot's own pages
    or on scratch: the outputs equal lane mode's and plain decode's."""
    cfg = get_config("qwen3-14b").reduced()
    spec = SpeculationConfig(fixed_k=4)
    lane = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                       speculation=spec).run(_requests(Request, cfg.vocab))
    eng = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu", speculation=spec,
                      paged=PagedConfig(page_size=4))
    assert eng._table_width == -(-(MAX_LEN + 4) // 4)
    fused = eng.run(_requests(Request, cfg.vocab))
    plain = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                        paged=PagedConfig(page_size=4)).run(_requests(Request, cfg.vocab))
    assert fused["outputs"] == lane["outputs"] == plain["outputs"]
    assert fused["paged"]["page_size"] == 4 and fused["paged"]["fused"]
    assert fused["spec"]["verify_steps"] > 0
    # the same pages stay resident at the end (published prefixes) as in
    # the plain run: the spans leaked none
    for k in ("hbm_bytes_resident", "prefix_hits", "prefix_misses", "cow_copies"):
        assert fused["paged"][k] == plain["paged"][k], k
