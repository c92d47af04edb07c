"""The port's ServeEngine on zamba2-7b --reduced against the JAX reference's
engine, with the reference's params carried across by ``load_jax_params``
and the same requests, all arriving at once so both engines see the same
admission sequence whatever the host's speed.

Greedy outputs must be equal token for token, and every count the reports
share equal too: the step and admission logs, slot reuse, prefill tokens,
``report["paged"]``'s counters and ``report["spec"]``'s; ``jit_cache`` in
lane mode (with ``commit`` under speculation). Fused paged mode reports the
step it captured under ``decode``, and its commit under ``commit_paged``,
an entry the reference has no counterpart for (its fused steps are jitted
apart from ``jit_cache_sizes``). zamba is the first family with both kinds
of state: fused paged mode keeps the Mamba2 tails in the slot table and the
shared attention's KV in the pools, and its speculative commit replays on
the pools. The cases follow the reference's tests: a freed slot refilled
mid-stream (``tests/test_serve.py``), bucket padding and a prefill beside a
decoding neighbour (``tests/test_serve_chunked.py``), fused paged decode
against lane mode with and without a shared prefix
(``tests/test_serve_fused_paged.py:105-107``), preemption under a tight page
budget (``tests/test_serve_paged.py``), n-gram and oracle
speculation in lane and fused mode with the commit
(``tests/test_serve_spec.py:30``), and admission's prices."""

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
from repro.serve.scheduler import HBM_BW as JAX_HBM_BW
from repro.serve.scheduler import PEAK_FLOPS as JAX_PEAK_FLOPS
from repro.serve.scheduler import CostModelAdmission as JaxAdmission
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (CostModelAdmission, PagedConfig, PagedKVStore, Request,
                               ServeEngine, SpeculationConfig, take_slot, validate_donor)

ARCH = "zamba2-7b"
PAGE = 4
COUNTED = ("requests", "generated_tokens", "steps", "padded_slot_steps_steady",
           "prefill_tokens", "buckets", "slot_reuse", "admission_log", "step_log",
           "refused", "sla_hit_rate")
PER_REQUEST = ("rid", "slot", "bucket", "tokens_out", "admitted_at_step", "spec_proposed",
               "spec_accepted", "verify_rounds", "preemptions")
PAGED = ("fused", "prefix_hits", "prefix_misses", "cow_copies", "lane_activations",
         "tail_restores", "spills", "rehydrates", "preemptions", "resident_requests_peak",
         "hbm_bytes_resident", "pages_used_peak", "n_pages", "page_bytes",
         "gather_bytes_eliminated")
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
    for k in COUNTED + (() if paged else ("jit_cache",)):
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
    slot (both kinds of state: the grouped tails at axis 2, the caches and
    the remainder at 1) and leaves the neighbour alone; reset_slot zeroes
    exactly it."""
    jcfg, cfg = cfgs
    model = build_model(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    _, want = jax_build_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)}, 12)
    _, donor = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 12)
    for k in donor:
        np.testing.assert_allclose(donor[k].numpy(), np.asarray(want[k]), atol=5e-5,
                                   rtol=1e-5)
    state = model.init_decode_state(2, 12)
    for leaf in state.values():
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    axes = model.state_batch_axes(state)
    assert axes == {"h": 2, "conv": 2, "attn_k": 1, "attn_v": 1}
    assert model.state_page_axes(state) == {"h": None, "conv": None, "attn_k": 3,
                                            "attn_v": 3}
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
    whose last chunk of 8 is all padding: the tails pass it untouched, and
    the engine emits the solo prefill + decode tokens."""
    cfg = cfgs[1]
    target = np.random.default_rng(0).integers(0, cfg.vocab, 17).astype(np.int32)
    jrep, rep = _serve(cfgs, params, lambda cls, v: [cls(rid="t", tokens=target, gen_len=6)],
                       max_len=40)
    _same(jrep, rep)
    assert rep["per_request"][0]["bucket"] == 32
    assert rep["outputs"]["t"] == _solo(cfg, params, target, 6)


def test_concurrent_prefill_is_exact(cfgs, params):
    """tests/test_serve_chunked.py:158: a 4-chunk prompt prefilled while a
    neighbour decodes emits exactly its solo tokens."""
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


# -- fused paged mode: both kinds of state ------------------------------------------


@pytest.fixture(scope="module")
def paged_runs(cfgs, params):
    """(reference, port) reports of the paged cases, built on first use."""
    cache = {}

    def run(name):
        if name not in cache:
            if name == "prefix":
                prefix = np.random.default_rng(7).integers(0, cfgs[1].vocab, 8).astype(
                    np.int32)

                def requests(cls, v):
                    return _gen_requests(cls, v, [5, 4, 4, 3], prompt_len=16, prefix=prefix)
            else:
                def requests(cls, v):
                    return _gen_requests(cls, v, [5, 4, 4, 3])
            cache[name] = (requests,) + _serve(
                cfgs, params, requests, jax_kw={"paged": JaxPagedConfig(page_size=PAGE)},
                kw={"paged": PagedConfig(page_size=PAGE)})
        return cache[name]

    return run


@pytest.mark.parametrize("name", ["plain", "prefix"])
def test_fused_paged_equals_the_reference_and_lane_mode(cfgs, params, paged_runs, name):
    """tests/test_serve_fused_paged.py:105-107: decode runs fused (the tails
    in the slot table, the KV straight off the pools, never a page->lane
    gather), more requests resident than lanes, and the tokens are the
    lane-mode engine's; with a shared 8-token prefix the later prompts hit
    the store and restore the tail at its boundary (by copy: every hit
    restores the same state) and prefill only their own chunk."""
    requests, jrep, rep = paged_runs(name)
    _same(jrep, rep, paged=True)
    lane = _port(cfgs, params, requests)
    assert rep["outputs"] == lane["outputs"]
    paged = rep["paged"]
    assert paged["fused"] and paged["lane_activations"] == 0 and paged["tail_restores"] > 0
    assert paged["resident_requests_peak"] > 2 and paged["gather_bytes_eliminated"] > 0
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}
    if name == "prefix":
        assert paged["prefix_hits"] == 3 and rep["prefill_tokens"] < lane["prefill_tokens"]


def test_the_flat_store_serves_the_same_as_fused(cfgs, paged_runs, params):
    """``fused=False``: requests activate by a page->lane gather of the KV
    and a tail restore, with the fused run's tokens and prefix counts."""
    requests, _, fused = paged_runs("prefix")
    flat = _port(cfgs, params, requests, kw={"paged": PagedConfig(page_size=PAGE,
                                                                  fused=False)})
    assert flat["outputs"] == fused["outputs"]
    assert not flat["paged"]["fused"] and flat["paged"]["lane_activations"] > 0
    same = ("prefix_hits", "prefix_misses", "resident_requests_peak")
    assert {k: flat["paged"][k] for k in same} == {k: fused["paged"][k] for k in same}
    # the fused store holds one page more: the scratch page idle slots read
    assert flat["paged"]["pages_used_peak"] == fused["paged"]["pages_used_peak"] - 1


def test_fused_preemption_returns_exact_tokens(cfgs, params):
    """tests/test_serve_paged.py's preemption case with both kinds of state:
    gen 10 on prompt 8 grows each request from 2 pages to 5 (page 4), and a
    pool of two requests' tails plus 4 pages exhausts on the growth; the
    preempted request's continuation re-prefills its tails and KV and emits
    the same tokens, as the reference's does."""
    cfg = cfgs[1]
    model = build_model(cfg, device="cpu")
    donor = model.init_decode_state(1, 24)
    probe = PagedKVStore({n: (tuple(t.shape), t.dtype) for n, t in donor.items()},
                         model.state_page_axes(donor), page_size=PAGE, ops=model.tsl,
                         n_pages=1, device="meta")
    budget = (1 + 2 * probe.tail_pages + 4) * probe.page_bytes

    def requests(cls, v):
        rng = np.random.default_rng(5)
        return [cls(rid=f"r{i}", tokens=rng.integers(0, v, 8).astype(np.int32), gen_len=10,
                    sla_s=600.0) for i in range(3)]

    jrep, rep = _serve(cfgs, params, requests,
                       jax_kw={"paged": JaxPagedConfig(page_size=PAGE, hbm_budget_bytes=budget)},
                       kw={"paged": PagedConfig(page_size=PAGE, hbm_budget_bytes=budget)})
    _same(jrep, rep, paged=True)
    assert rep["paged"]["fused"] and rep["paged"]["preemptions"] >= 1
    assert any(m["preemptions"] >= 1 for m in rep["per_request"])
    assert rep["outputs"] == _port(cfgs, params, requests)["outputs"]


# -- speculation: the verify step and the commit replay, lane and fused ---------------


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
            if mode == "fused":
                kw["paged"] = PagedConfig(page_size=PAGE)
            cache[kind, mode] = _port(cfgs, params, _spec_requests, kw=kw, max_len=48)
        return cache[kind, mode]

    return run


@pytest.mark.parametrize("mode", ["lane", "fused"])
@pytest.mark.parametrize("kind", ["fixed_k3", "priced"])
def test_ngram_speculation_equals_the_reference_and_plain(cfgs, params, spec_runs, kind,
                                                          mode):
    """tests/test_serve_spec.py:30 (the recurrent family): greedy speculative
    tokens equal plain decode's; the verify step leaves the tails and the
    commit replays each accepted prefix, in lanes (jit_cache ``commit``) or
    on the pools (``commit_paged``)."""
    jax.clear_caches()
    spec = JaxSpeculationConfig(fixed_k=3) if kind == "fixed_k3" else JaxSpeculationConfig()
    jkw = {"paged": JaxPagedConfig(page_size=PAGE)} if mode == "fused" else {}
    jrep = JaxServeEngine(cfgs[0], batch=2, max_len=48, seed=0, admission=False,
                          speculation=spec, **jkw).run(_spec_requests(JaxRequest,
                                                                      cfgs[0].vocab))
    rep = spec_runs(kind, mode)
    _same(jrep, rep, paged=mode == "fused", spec=True)
    assert rep["outputs"] == spec_runs()["outputs"]
    cache = rep["jit_cache"]
    if kind == "fixed_k3":
        assert rep["spec"]["verify_steps"] > 0
        if mode == "lane":
            assert cache["commit"] == cache["verify"] > 0 and "commit_paged" not in cache
        else:
            assert rep["paged"]["fused"] and rep["paged"]["verify_steps"] > 0
            assert cache["commit_paged"] == cache["verify"] > 0 and cache["commit"] == 0


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


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_oracle_drafter_fully_accepts_through_the_commit(cfgs, params, mode):
    """tests/test_serve_spec.py:161: every draft accepted, the per-slot
    steps per emitted token under 1/2, the tokens plain decode's, and the
    counts the reference engine's under the same oracle."""
    jax.clear_caches()
    jcfg, cfg = cfgs
    kw = dict(batch=2, max_len=48, admission=False, seed=0)
    paged = {"paged": PagedConfig(page_size=PAGE)} if mode == "fused" else {}
    jpaged = {"paged": JaxPagedConfig(page_size=PAGE)} if mode == "fused" else {}
    plain = ServeEngine(cfg, device="cpu", params=params, **kw).run(
        _spec_requests(Request, cfg.vocab))
    lens = {r.rid: r.prompt_len for r in _spec_requests(Request, cfg.vocab)}
    eng = ServeEngine(cfg, device="cpu", params=params,
                      speculation=SpeculationConfig(fixed_k=3), **paged, **kw)
    eng._drafter = _OracleDrafter(plain["outputs"], lens)
    rep = eng.run(_spec_requests(Request, cfg.vocab))
    jeng = JaxServeEngine(jcfg, speculation=JaxSpeculationConfig(fixed_k=3), **jpaged, **kw)
    jeng._drafter = _OracleDrafter(plain["outputs"], lens)
    jrep = jeng.run(_spec_requests(JaxRequest, jcfg.vocab))
    assert rep["outputs"] == plain["outputs"] == jrep["outputs"]
    _same(jrep, rep, paged=mode == "fused", spec=True)
    assert rep["spec"]["accepted_rate"] == 1.0
    assert rep["spec"]["slot_steps_per_emitted_token"] < 0.5


# -- admission -------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_admission_prices_zamba_as_the_reference(reduced):
    """n_layers // attn_every attention layers read a cache in a decode step
    (13 for zamba2-7b), a verify step pays twice for the commit replay, and
    prefill prices the shared block's chunks: every price the reference
    scheduler's (its SSD state term is a tensor-parallel collective, 0 at
    one shard, in both)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    ours = CostModelAdmission(cfg, 8, 320, lib=tsl_api.lib("cpu"))
    ref = JaxAdmission(jcfg, 8, 320)
    assert ours.param_bytes == ref.param_bytes
    assert ours._attn_layers == ref._attn_layers == cfg.n_layers // cfg.attn_every
    # the reference divides by its TPU's rates, the port by the h100 SRU's:
    # the bytes and flops behind each price are the same
    for s in (None, 64, 300):
        assert ours.decode_bytes_per_step(s) == pytest.approx(ref.decode_bytes_per_step(s))
        assert ours.step_seconds(s) * ours.hbm_bw == pytest.approx(
            ref.step_seconds(s) * JAX_HBM_BW)
        for k in (1, 4):
            assert ours.verify_seconds(k, s) * ours.hbm_bw == pytest.approx(
                ref.verify_seconds(k, s) * JAX_HBM_BW)
    for n in (64, 256):
        assert ours.prefill_seconds(n) * ours.peak_flops == pytest.approx(
            ref.prefill_seconds(n) * JAX_PEAK_FLOPS)
    assert ours.verify_seconds(2) > 2.0 * ours.param_bytes / ours.hbm_bw


def test_the_serve_cli_serves_zamba_reduced():
    """``python -m repro_torch.launch.serve --arch zamba2-7b --reduced``: the
    CLI's own seeded weights, every request answered in full, lane mode's
    captured steps reported."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-len", "12", "--gen-len", "5",
                      "--prefill-chunk", "8"])
    assert out["arch"] == "zamba2-7b-reduced" and out["target"] == "torch_cpu"
    assert out["tokens_per_request"] == {"req0": 5, "req1": 5, "req2": 5}
    assert out["refused"] == [] and out["jit_cache"] == {"prefill_chunk": 1, "decode": 1}
