"""The port's ServeEngine on rwkv6-7b --reduced against the JAX reference's
engine, with the reference's params carried across by ``load_jax_params``
and the same requests, all arriving at once so both engines see the same
admission sequence whatever the host's speed.

Greedy outputs must be equal token for token, and every count the reports
share equal too: the step and admission logs, slot reuse, prefill tokens,
``report["paged"]``'s counters, ``report["spec"]``'s and ``jit_cache``
(with ``commit``). The cases are the reference's own tests of the
recurrent family: a freed slot refilled mid-stream, slot surgery, bucket
padding (prompt 17 in a bucket of 32 whose last chunk is all padding), a
prefill running beside a decoding neighbour, paged mode falling back to
lanes (with and without a shared prefix), n-gram speculation with the
commit replay, an oracle drafter, and the commit's price. Model-level
checks hold states within 2e-5 absolute + 1e-5 relative (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro.serve import PagedConfig as JaxPagedConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpeculationConfig as JaxSpeculationConfig
from repro_torch.configs import get_config
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (PagedConfig, Request, ServeEngine, SpeculationConfig,
                               take_slot, validate_donor)

ARCH = "rwkv6-7b"
COUNTED = ("requests", "generated_tokens", "steps", "padded_slot_steps_steady",
           "prefill_tokens", "buckets", "slot_reuse", "admission_log", "step_log",
           "refused", "sla_hit_rate", "jit_cache")
PER_REQUEST = ("rid", "slot", "bucket", "tokens_out", "admitted_at_step", "spec_proposed",
               "spec_accepted", "verify_rounds", "preemptions")
PAGED = ("fused", "prefix_hits", "prefix_misses", "cow_copies", "lane_activations",
         "tail_restores", "spills", "rehydrates", "preemptions", "resident_requests_peak",
         "hbm_bytes_resident")
SPEC = ("decode_steps", "verify_steps", "drafted_tokens", "accepted_tokens",
        "accept_by_bucket")
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def jparams(cfgs):
    """The reference engine's own weights (``init(PRNGKey(seed=0))``)."""
    return jax_build_model(cfgs[0]).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfgs, jparams):
    return load_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], "cpu")


def _gen_requests(cls, vocab, gen_lens, prompt_len=8, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(gen_lens):
        toks = rng.integers(0, vocab, prompt_len).astype(np.int32)
        if prefix is not None:
            toks[:len(prefix)] = prefix
        out.append(cls(rid=f"r{i}", tokens=toks, gen_len=g, sla_s=600.0,
                       shared_prefix_len=None if prefix is None else len(prefix)))
    return out


def _spec_requests(cls, vocab):
    """tests/test_serve_spec.py's three requests over 2 slots."""
    rnd = np.random.default_rng(0).integers(1, vocab, 5)
    return [cls(rid="a", tokens=np.array(REPETITIVE), gen_len=9),
            cls(rid="b", tokens=rnd, gen_len=6),
            cls(rid="c", tokens=np.array(REPETITIVE[:7]), gen_len=8)]


def _port(cfgs, params, requests, *, kw=None, batch=2, max_len=24):
    cfg = cfgs[1]
    return ServeEngine(cfg, batch=batch, max_len=max_len, device="cpu", params=params,
                       **(kw or {})).run(requests(Request, cfg.vocab))


def _serve(cfgs, params, requests, *, jax_kw=None, kw=None, batch=2, max_len=24):
    """(reference report, port report): ``requests(cls, vocab)`` through both
    engines, the reference with ``jax_kw``, the port with ``kw``."""
    jax.clear_caches()
    jcfg = cfgs[0]
    jrep = JaxServeEngine(jcfg, batch=batch, max_len=max_len, seed=0, **(jax_kw or {})).run(
        requests(JaxRequest, jcfg.vocab))
    return jrep, _port(cfgs, params, requests, kw=kw, batch=batch, max_len=max_len)


def _same(jrep, rep, paged=False, spec=False):
    assert rep["outputs"] == jrep["outputs"]
    for k in COUNTED:
        assert rep[k] == jrep[k], k

    def per_request(r):
        return {m["rid"]: tuple(m[k] for k in PER_REQUEST) for m in r["per_request"]}

    assert per_request(rep) == per_request(jrep)
    if paged:
        assert {k: rep["paged"][k] for k in PAGED} == {k: jrep["paged"][k] for k in PAGED}
    if spec:
        assert {k: rep["spec"][k] for k in SPEC} == {k: jrep["spec"][k] for k in SPEC}


def _solo(cfg, params, tokens, gen, max_len=40):
    """Greedy tokens of whole-prompt prefill + decode steps, no engine."""
    model = build_model(cfg, device="cpu")
    logits, state = model.prefill(params, {"tokens": torch.from_numpy(tokens[None])}, max_len)
    out = [int(logits[0, :cfg.vocab].argmax())]
    for i in range(gen - 1):
        logits, state = model.decode_step(params, state, torch.tensor([[out[-1]]]),
                                          len(tokens) + i)
        out.append(int(logits[0, :cfg.vocab].argmax()))
    return out


# -- lane mode -------------------------------------------------------------------


def test_admits_into_a_freed_slot_mid_stream(cfgs, params):
    """tests/test_serve.py:89: batch 2, four requests of staggered lengths;
    a freed slot is refilled before the long neighbour finishes."""
    jrep, rep = _serve(cfgs, params, lambda cls, v: _gen_requests(cls, v, [4, 12, 6, 12]))
    _same(jrep, rep)
    assert rep["generated_tokens"] == 34 and rep["padded_slot_steps_steady"] == 0
    assert max(rep["slot_reuse"]) >= 2 and rep["sla_hit_rate"] == 1.0
    steps = {e["rid"]: e["step"] for e in rep["admission_log"]}
    assert 0 < steps["r2"] < 12 - 1, steps
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}


def test_slot_surgery_insert_take_reset(cfgs, params, jparams):
    """tests/test_serve.py:251: insert_slot grafts a batch-1 prefill into one
    slot and leaves the neighbour alone; reset_slot zeroes exactly it."""
    jcfg, cfg = cfgs
    model = build_model(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    _, want = jax_build_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)}, 12)
    _, donor = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 12)
    for k in donor:
        np.testing.assert_allclose(donor[k].numpy(), np.asarray(want[k]), atol=2e-5,
                                   rtol=1e-5)
    state = model.init_decode_state(2, 12)
    for leaf in state.values():
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    axes = model.state_batch_axes(state)
    assert axes == {"tm_prev": 1, "cm_prev": 1, "s": 1}
    assert model.state_page_axes(state) == {"tm_prev": None, "cm_prev": None, "s": None}
    neighbour = {k: v.clone() for k, v in take_slot(state, axes, 0).items()}
    validate_donor(state, donor, axes)
    model.insert_slot(state, donor, 1)
    for k, v in take_slot(state, axes, 1).items():
        assert torch.equal(v, donor[k])
    for k, v in take_slot(state, axes, 0).items():
        assert torch.equal(v, neighbour[k])
    model.reset_slot(state, 1)
    assert all(torch.count_nonzero(v) == 0 for v in take_slot(state, axes, 1).values())
    assert all(torch.equal(v, neighbour[k]) for k, v in take_slot(state, axes, 0).items())


def test_bucket_padding_is_exact(cfgs, params):
    """tests/test_serve_chunked.py:114: prompt 17 pads to the bucket of 32,
    whose last chunk of 8 is all padding: the recurrent carries pass it
    untouched, and the engine emits the solo prefill + decode tokens."""
    cfg = cfgs[1]
    target = np.random.default_rng(0).integers(0, cfg.vocab, 17).astype(np.int32)
    jrep, rep = _serve(cfgs, params, lambda cls, v: [cls(rid="t", tokens=target, gen_len=6)],
                       max_len=40)
    _same(jrep, rep)
    assert rep["per_request"][0]["bucket"] == 32
    assert rep["outputs"]["t"] == _solo(cfg, params, target, 6)


def test_concurrent_prefill_is_exact(cfgs, params):
    """tests/test_serve_chunked.py:158: a 4-chunk prompt prefilled while a
    neighbour decodes emits exactly its solo tokens (the donor lives outside
    the slot table until grafted). Both arrive at once: the neighbour's one
    chunk completes at step 0, and it decodes through the long prompt's
    chunks 1-3."""
    cfg = cfgs[1]
    rng = np.random.default_rng(0)
    long_tokens = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    runner_tokens = rng.integers(0, cfg.vocab, 6).astype(np.int32)

    def requests(cls, vocab):
        return [cls(rid="runner", tokens=runner_tokens, gen_len=40),
                cls(rid="long", tokens=long_tokens, gen_len=5)]

    jrep, rep = _serve(cfgs, params, requests, max_len=48)
    _same(jrep, rep)
    long_steps = [e for e in rep["step_log"] if "long" in e["prefill_rids"]]
    assert sum(e["decoded"] >= 1 for e in long_steps) == 3
    assert rep["outputs"]["long"] == _solo(cfg, params, long_tokens, 5, max_len=48)


# -- paged mode: the lane fallback -------------------------------------------------


def test_paged_falls_back_to_lanes_and_equals_contiguous(cfgs, params):
    """tests/test_serve_paged.py:302 and test_serve_fused_paged.py:138: no
    leaf pages, so there is no fused contract: fused reads false, requests
    park and activate through lanes, more of them resident than lanes, and
    the tokens are the contiguous engine's; asking for the flat store
    (``fused=False``) serves the same way."""
    def requests(cls, v):
        return _gen_requests(cls, v, [5, 4, 4, 3])

    jrep, rep = _serve(cfgs, params, requests, jax_kw={"paged": JaxPagedConfig()},
                       kw={"paged": PagedConfig()})
    _same(jrep, rep, paged=True)
    assert rep["outputs"] == _port(cfgs, params, requests)["outputs"]
    paged = rep["paged"]
    assert not paged["fused"] and paged["lane_activations"] > 0
    assert paged["resident_requests_peak"] > 2 and paged["hbm_bytes_resident"] == 0
    flat = _port(cfgs, params, requests, kw={"paged": PagedConfig(fused=False)})
    assert flat["outputs"] == rep["outputs"]
    assert {k: flat["paged"][k] for k in PAGED} == {k: paged[k] for k in PAGED}


def test_paged_shares_a_prefix_as_the_tail_at_its_boundary(cfgs, params):
    """Four prompts of 16 sharing their first 8 tokens (one chunk): the first
    publishes the state after them, the others restore it and prefill only
    their own chunk; every token equals the contiguous engine's."""
    prefix = np.random.default_rng(7).integers(0, cfgs[1].vocab, 8).astype(np.int32)

    def requests(cls, v):
        return _gen_requests(cls, v, [5, 4, 4, 3], prompt_len=16, prefix=prefix)

    jrep, rep = _serve(cfgs, params, requests, jax_kw={"paged": JaxPagedConfig()},
                       kw={"paged": PagedConfig()})
    _same(jrep, rep, paged=True)
    contiguous = _port(cfgs, params, requests)
    assert rep["outputs"] == contiguous["outputs"]
    assert rep["paged"]["prefix_hits"] > 0 and rep["prefill_tokens"] < \
        contiguous["prefill_tokens"]


# -- speculation: the verify step and the commit replay -------------------------------


@pytest.fixture(scope="module")
def spec_runs(cfgs, params):
    """The port's reports on the speculation requests, built on first use:
    plain decode, and n-gram speculation per (depth policy, mode)."""
    cache = {}

    def run(kind=None, mode="lane"):
        if (kind, mode) not in cache:
            kw = {"admission": False}
            if kind is not None:
                kw["speculation"] = SpeculationConfig(fixed_k=3) if kind == "fixed_k3" \
                    else SpeculationConfig()
            if mode == "paged":
                kw["paged"] = PagedConfig()
            cache[kind, mode] = _port(cfgs, params, _spec_requests, kw=kw, max_len=48)
        return cache[kind, mode]

    return run


@pytest.mark.parametrize("kind", ["fixed_k3", "priced"])
def test_ngram_speculation_equals_the_reference_and_plain(cfgs, params, spec_runs, kind):
    """tests/test_serve_spec.py:28 (the recurrent family): greedy speculative
    tokens equal plain decode's; the verify step writes nothing and the
    commit replays each accepted prefix (jit_cache gains ``commit``)."""
    jax.clear_caches()
    spec = JaxSpeculationConfig(fixed_k=3) if kind == "fixed_k3" else JaxSpeculationConfig()
    jrep = JaxServeEngine(cfgs[0], batch=2, max_len=48, seed=0, admission=False,
                          speculation=spec).run(_spec_requests(JaxRequest, cfgs[0].vocab))
    rep = spec_runs(kind)
    _same(jrep, rep, spec=True)
    assert rep["outputs"] == spec_runs()["outputs"]
    if kind == "fixed_k3":
        assert rep["spec"]["verify_steps"] > 0
        assert rep["jit_cache"]["commit"] == rep["jit_cache"]["verify"] > 0


def test_paged_speculation_serves_from_lanes_as_lane_mode(spec_runs):
    """Speculation in paged mode: the lane fallback runs the same verify and
    commit steps, so tokens and speculation counts are lane mode's."""
    lane, paged = spec_runs("fixed_k3"), spec_runs("fixed_k3", "paged")
    assert paged["outputs"] == lane["outputs"] == spec_runs()["outputs"]
    assert not paged["paged"]["fused"] and paged["paged"]["verify_steps"] > 0
    assert {k: paged["spec"][k] for k in SPEC} == {k: lane["spec"][k] for k in SPEC}
    assert paged["jit_cache"] == lane["jit_cache"]


class _OracleDrafter:
    """Replays the plain engine's greedy outputs as drafts (drafter ==
    target): every in-window draft is accepted, so the commit replays up to
    k + 1 rows per slot. Serves either engine."""

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


def test_oracle_drafter_fully_accepts_through_the_commit(cfgs, params):
    """tests/test_serve_spec.py:161: every draft accepted, the per-slot
    steps per emitted token under 1/2, the tokens plain decode's, and the
    counts the reference engine's under the same oracle."""
    jax.clear_caches()
    jcfg, cfg = cfgs
    kw = dict(batch=2, max_len=48, admission=False, seed=0)
    plain = ServeEngine(cfg, device="cpu", params=params, **kw).run(
        _spec_requests(Request, cfg.vocab))
    lens = {r.rid: r.prompt_len for r in _spec_requests(Request, cfg.vocab)}
    eng = ServeEngine(cfg, device="cpu", params=params,
                      speculation=SpeculationConfig(fixed_k=3), **kw)
    eng._drafter = _OracleDrafter(plain["outputs"], lens)
    rep = eng.run(_spec_requests(Request, cfg.vocab))
    jeng = JaxServeEngine(jcfg, speculation=JaxSpeculationConfig(fixed_k=3), **kw)
    jeng._drafter = _OracleDrafter(plain["outputs"], lens)
    jrep = jeng.run(_spec_requests(JaxRequest, jcfg.vocab))
    assert rep["outputs"] == plain["outputs"] == jrep["outputs"]
    _same(jrep, rep, spec=True)
    assert rep["spec"]["accepted_rate"] == 1.0
    assert rep["spec"]["slot_steps_per_emitted_token"] < 0.5
    for stats in rep["spec"]["accept_by_bucket"].values():
        assert stats["accepted_rate"] == 1.0 and stats["mean_accepted_span"] > 1.0


def test_the_commit_doubles_the_verify_price(cfgs):
    """tests/test_serve_spec.py:318: a recurrent verify step is priced at
    twice the param stream (the commit replays the accepted prefix), and
    the engine reports it."""
    cfg = cfgs[1]
    eng = ServeEngine(cfg, batch=2, max_len=48, device="cpu",
                      speculation=SpeculationConfig(fixed_k=2))
    cm = eng.cost_model
    assert cm.verify_seconds(2) == pytest.approx(2.0 * cm.param_bytes / cm.hbm_bw)
    assert cm.decode_bytes_per_step() == cm.param_bytes
    rep = eng.run(_spec_requests(Request, cfg.vocab)[:1])
    assert rep["cost_model"]["verify_seconds_k_max"] == pytest.approx(
        2.0 * cm.param_bytes / cm.hbm_bw)
