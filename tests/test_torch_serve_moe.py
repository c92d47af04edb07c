"""The port's ServeEngine on the moe family's reduced configs (grok-1-314b:
4 experts top-2; arctic-480b: the same plus a dense residual MLP) against
the JAX reference's engine, with the reference's params carried across by
``load_jax_params`` and the same requests, all arriving at once.

A moe step routes all of its rows together, and a row past an expert's
capacity is dropped: a token's output depends on every other row of the
step, padding rows and idle slots included. So only the same step schedule
gives the same outputs, and the engines are held to the same admission
sequence, chunk schedule and idle-slot inputs by comparing, beside greedy
outputs token for token, every count the reports share: the step and
admission logs, slot reuse, prefill tokens, ``report["paged"]``'s and
``report["spec"]``'s counters, and ``jit_cache`` in lane mode. Prompts of
16 tokens prefilled in one chunk of 16 route 32 rows over 4 experts at
capacity 10, so that chunk drops rows; the decode steps at batch 2 route 4
rows at capacity 8 and drop none. The cases follow the reference's tests:
a freed slot refilled mid-stream (``tests/test_serve.py:89-101``), fused
paged decode against lane mode with a shared prefix
(``tests/test_serve_fused_paged.py:59``), n-gram speculation lane and fused
(``tests/test_serve_spec.py:32``), both on grok's config; then
admission's prices (the active parameters) and the serve CLI."""

import functools

import jax
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
from repro_torch.nn import lm, moe
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import CostModelAdmission, PagedConfig, Request, ServeEngine, \
    SpeculationConfig

PAGE = 4
COUNTED = ("requests", "generated_tokens", "steps", "padded_slot_steps_steady",
           "prefill_tokens", "buckets", "slot_reuse", "admission_log", "step_log",
           "refused", "sla_hit_rate")
PER_REQUEST = ("rid", "slot", "bucket", "tokens_out", "admitted_at_step", "spec_proposed",
               "spec_accepted", "verify_rounds", "preemptions")
PAGED = ("fused", "prefix_hits", "prefix_misses", "cow_copies", "lane_activations",
         "tail_restores", "spills", "rehydrates", "preemptions", "resident_requests_peak",
         "hbm_bytes_resident", "pages_used_peak", "n_pages", "page_bytes", "int8",
         "gather_bytes_eliminated")
SPEC = ("decode_steps", "verify_steps", "drafted_tokens", "accepted_tokens",
        "accept_by_bucket")
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]


@functools.cache
def _setup(arch):
    """(reference cfg, port cfg, the reference engine's own weights)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(params=["grok-1-314b", "arctic-480b"])
def setup(request):
    return _setup(request.param)


def _gen_requests(cls, vocab, gen_lens, prompt_len=16, seed=0, head=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(gen_lens):
        toks = rng.integers(0, vocab, prompt_len).astype(np.int32)
        if head is not None:
            toks[:len(head)] = head
        out.append(cls(rid=f"r{i}", tokens=toks, gen_len=g, sla_s=600.0,
                       shared_prefix_len=None if head is None else len(head)))
    return out


def _spec_requests(cls, vocab):
    """tests/test_serve_spec.py's three requests over 2 slots."""
    rnd = np.random.default_rng(0).integers(1, vocab, 5)
    return [cls(rid="a", tokens=np.array(REPETITIVE), gen_len=9),
            cls(rid="b", tokens=rnd, gen_len=6),
            cls(rid="c", tokens=np.array(REPETITIVE[:7]), gen_len=8)]


def _port(setup, requests, *, kw=None, batch=2, max_len=32):
    _, cfg, params = setup
    return ServeEngine(cfg, batch=batch, max_len=max_len, device="cpu", params=params,
                       **(kw or {})).run(requests(Request, cfg.vocab))


def _serve(setup, requests, *, jax_kw=None, kw=None, batch=2, max_len=32):
    """(reference report, port report): ``requests(cls, vocab)`` through
    both engines, the reference with ``jax_kw``, the port with ``kw``."""
    jax.clear_caches()
    jcfg = setup[0]
    jrep = JaxServeEngine(jcfg, batch=batch, max_len=max_len, seed=0, **(jax_kw or {})).run(
        requests(JaxRequest, jcfg.vocab))
    return jrep, _port(setup, requests, kw=kw, batch=batch, max_len=max_len)


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


class _Drops:
    """A library's ops that count the rows ``moe_dispatch`` drops."""

    def __init__(self, ops):
        self._ops, self.dropped = ops, 0

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name != "moe_dispatch":
            return fn

        def counted(*args, **kw):
            xe, info = fn(*args, **kw)
            self.dropped += int((~info[2]).sum())
            return xe, info
        return counted


def test_admits_into_a_freed_slot_mid_stream(setup):
    """tests/test_serve.py:89-101: batch 2, four requests of staggered
    lengths, each prompt one chunk of 16 (32 rows at capacity 10: the
    prompts' chunks drop rows); a freed slot is refilled before the long
    neighbour finishes."""
    _, cfg, params = setup
    assert moe.capacity_for(cfg, 16) == 10 and moe.capacity_for(cfg, 2) == 8
    spy = _Drops(build_model(cfg, device="cpu").tsl)
    for r in _gen_requests(Request, cfg.vocab, [4, 12, 6, 12]):
        lm.lm_prefill_chunk(spy, params, lm.init_decode_state(cfg, 1, 32, torch.float32, "cpu"),
                            torch.from_numpy(np.asarray(r.tokens, np.int64))[None], 0, cfg)
    assert spy.dropped > 0
    jrep, rep = _serve(setup, lambda cls, v: _gen_requests(cls, v, [4, 12, 6, 12]),
                       kw={"prefill_chunk": 16}, jax_kw={"prefill_chunk": 16})
    _same(jrep, rep)
    assert rep["generated_tokens"] == 34 and rep["padded_slot_steps_steady"] == 0
    assert max(rep["slot_reuse"]) >= 2
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}


def test_fused_paged_with_a_shared_prefix_equals_the_reference_and_lane():
    """tests/test_serve_fused_paged.py:59 with an 8-token shared head, on
    grok's config (arctic's steps differ only in the dense residual MLP,
    which its lane case holds): decode runs fused straight off the pools,
    idle slots on all-scratch table rows (their rows route with the others,
    as in the reference); the head is prefilled once and hit by the others.
    Outputs and counts equal the reference engine's; outputs equal the lane
    engine's."""
    setup = _setup("grok-1-314b")
    def requests(cls, v):
        return _gen_requests(cls, v, [5, 4, 4, 3], seed=3, head=np.arange(1, 9))

    jrep, rep = _serve(setup, requests, jax_kw={"paged": JaxPagedConfig(page_size=PAGE)},
                       kw={"paged": PagedConfig(page_size=PAGE)})
    _same(jrep, rep, paged=True)
    paged = rep["paged"]
    assert paged["fused"] and paged["lane_activations"] == 0
    assert paged["prefix_misses"] == 1 and paged["prefix_hits"] == 3
    assert rep["outputs"] == _port(setup, requests)["outputs"]


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_ngram_speculation_equals_the_reference(mode):
    setup = _setup("grok-1-314b")
    """tests/test_serve_spec.py:32 (the moe family): greedy speculative
    tokens at fixed_k 3 equal the reference engine's and plain decode's (a
    verify span's 8 rows route at capacity 8: each expert takes at most
    one row a token, so none is dropped)."""
    jax.clear_caches()
    jkw = {"paged": JaxPagedConfig(page_size=PAGE)} if mode == "fused" else {}
    jcfg = setup[0]
    jrep = JaxServeEngine(jcfg, batch=2, max_len=40, seed=0, admission=False,
                          speculation=JaxSpeculationConfig(fixed_k=3), **jkw).run(
        _spec_requests(JaxRequest, jcfg.vocab))
    kw = {"admission": False, "speculation": SpeculationConfig(fixed_k=3)}
    if mode == "fused":
        kw["paged"] = PagedConfig(page_size=PAGE)
    rep = _port(setup, _spec_requests, kw=kw, max_len=40)
    _same(jrep, rep, paged=mode == "fused", spec=True)
    assert rep["spec"]["verify_steps"] > 0 and "commit" not in rep["jit_cache"]
    plain = _port(setup, _spec_requests, kw={"admission": False}, max_len=40)
    assert rep["outputs"] == plain["outputs"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_admission_prices_moe_as_the_reference(arch, reduced):
    """The params a token streams are the ACTIVE ones (the routed experts:
    grok-1-314b 86 B of 316 B): every price the reference scheduler's."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    ours = CostModelAdmission(cfg, 8, 320, lib=tsl_api.lib("cpu"))
    ref = JaxAdmission(jcfg, 8, 320)
    assert ours.param_bytes == ref.param_bytes
    assert ours.param_bytes == cfg.param_count(active_only=True) * (4 if reduced else 2)
    assert ours.param_bytes < cfg.param_count() * (4 if reduced else 2)
    assert ours._attn_layers == ref._attn_layers == cfg.n_layers
    for s in (None, 64, 300):
        assert ours.step_seconds(s) * ours.hbm_bw == pytest.approx(
            ref.step_seconds(s) * JAX_HBM_BW)
        assert ours.verify_seconds(4, s) * ours.hbm_bw == pytest.approx(
            ref.verify_seconds(4, s) * JAX_HBM_BW)
    for n in (64, 256):
        assert ours.prefill_seconds(n) * ours.peak_flops == pytest.approx(
            ref.prefill_seconds(n) * JAX_PEAK_FLOPS)


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_the_serve_cli_serves_moe_reduced(arch):
    """``python -m repro_torch.launch.serve --arch <moe> --reduced``: every
    request answered in full."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-len", "12", "--gen-len", "5",
                      "--prefill-chunk", "8"])
    assert out["arch"] == f"{arch}-reduced" and out["target"] == "torch_cpu"
    assert out["tokens_per_request"] == {"req0": 5, "req1": 5, "req2": 5}
    assert out["refused"] == [] and out["jit_cache"] == {"prefill_chunk": 1, "decode": 1}
