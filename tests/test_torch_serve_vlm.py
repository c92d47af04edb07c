"""The port's ServeEngine on internvl2-2b --reduced (8 vision rows) against
the JAX reference's engine, with the reference's params carried across by
``load_jax_params`` and the same requests (each with its own seeded patch
embeddings), all arriving at once so both engines see the same admission
sequence whatever the host's speed.

Greedy outputs must be equal token for token, and every count the reports
share equal too: the step and admission logs, slot reuse, prefill tokens,
``report["paged"]``'s counters and ``report["spec"]``'s, and ``jit_cache``
in lane mode. The first chunk of a prompt carries the vision rows ahead of
its tokens: a compiled entry of its own in both engines. The cases follow
the reference's tests: a freed slot refilled mid-stream
(``tests/test_serve.py:89-101``), the vision prefix's accounting
(``tests/test_serve.py:155``), fused paged decode against lane mode
(``tests/test_serve_fused_paged.py:59``), n-gram speculation lane and fused
(``tests/test_serve_spec.py:32``); then the prefix store keyed by the
images, the engine's refusals, admission's prices and the serve CLI."""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro.serve import BucketPolicy as JaxBucketPolicy
from repro.serve import PagedConfig as JaxPagedConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpeculationConfig as JaxSpeculationConfig
from repro.serve.scheduler import HBM_BW as JAX_HBM_BW
from repro.serve.scheduler import PEAK_FLOPS as JAX_PEAK_FLOPS
from repro.serve.scheduler import CostModelAdmission as JaxAdmission
from repro.serve.scheduler import PagedAdmission as JaxPagedAdmission
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.nn.model import load_jax_params
from repro_torch.serve import (BucketPolicy, CostModelAdmission, PagedAdmission, PagedConfig,
                               Request, ServeEngine, SpeculationConfig)

ARCH = "internvl2-2b"
PREFIX = 8                        # the reduced config's vision rows
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


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def params(cfgs):
    """The reference engine's own weights (``init(PRNGKey(seed=0))``)."""
    jparams = jax_build_model(cfgs[0]).init(jax.random.PRNGKey(0))
    return load_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], "cpu")


def _image(rng, d):
    return rng.normal(size=(PREFIX, d)).astype(np.float32)


def _gen_requests(cls, vocab, d, gen_lens, prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=f"r{i}", tokens=rng.integers(0, vocab, prompt_len).astype(np.int32),
                gen_len=g, sla_s=600.0, embeds=_image(rng, d))
            for i, g in enumerate(gen_lens)]


def _spec_requests(cls, vocab, d):
    """tests/test_serve_spec.py's three requests over 2 slots, with images."""
    rng = np.random.default_rng(0)
    rnd = rng.integers(1, vocab, 5)
    return [cls(rid="a", tokens=np.array(REPETITIVE), gen_len=9, embeds=_image(rng, d)),
            cls(rid="b", tokens=rnd, gen_len=6, embeds=_image(rng, d)),
            cls(rid="c", tokens=np.array(REPETITIVE[:7]), gen_len=8, embeds=_image(rng, d))]


def _port(cfgs, params, requests, *, kw=None, batch=2, max_len=PREFIX + 24):
    cfg = cfgs[1]
    return ServeEngine(cfg, batch=batch, max_len=max_len, device="cpu", params=params,
                       **(kw or {})).run(requests(Request, cfg.vocab, cfg.d_model))


def _serve(cfgs, params, requests, *, jax_kw=None, kw=None, batch=2, max_len=PREFIX + 24):
    """(reference report, port report): ``requests(cls, vocab, d)`` through
    both engines, the reference with ``jax_kw``, the port with ``kw``."""
    jax.clear_caches()
    jcfg = cfgs[0]
    jrep = JaxServeEngine(jcfg, batch=batch, max_len=max_len, seed=0, **(jax_kw or {})).run(
        requests(JaxRequest, jcfg.vocab, jcfg.d_model))
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


# -- lane mode -------------------------------------------------------------------


def test_admits_into_a_freed_slot_mid_stream(cfgs, params):
    """tests/test_serve.py:89-101 with 8 vision rows: batch 2, four requests
    of staggered lengths; a freed slot is refilled before the long
    neighbour finishes (its vision rows and prompt replaced by the new
    request's)."""
    jrep, rep = _serve(cfgs, params,
                       lambda cls, v, d: _gen_requests(cls, v, d, [4, 12, 6, 12]))
    _same(jrep, rep)
    assert rep["generated_tokens"] == 34 and rep["padded_slot_steps_steady"] == 0
    assert max(rep["slot_reuse"]) >= 2 and rep["sla_hit_rate"] == 1.0
    steps = {e["rid"]: e["step"] for e in rep["admission_log"]}
    assert 0 < steps["r2"] < 12 - 1, steps
    # prompts of one chunk: every chunk is a first chunk, with its image
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}


def test_two_chunk_prompts_and_a_request_without_an_image(cfgs, params):
    """Prompts of 16 tokens (two chunks): the chunk with the vision rows and
    the later one are two compiled entries, as in the reference; a request
    that carries no image is served behind zero rows (the reference's
    ``_first_chunk_embeds``)."""
    def requests(cls, v, d):
        out = _gen_requests(cls, v, d, [3, 5, 4], prompt_len=16)
        out[1].embeds = None
        return out

    jrep, rep = _serve(cfgs, params, requests, max_len=PREFIX + 32)
    _same(jrep, rep)
    assert rep["jit_cache"] == {"prefill_chunk": 2, "decode": 1}


def test_the_vision_prefix_is_accounted(cfgs, params):
    """tests/test_serve.py:155: prompts of 6 pad to bucket 8 and sit behind
    the 8 vision rows; decode writes after them, every request is served
    in a table of prefix + 8 + 4 rows; a request whose bucket fits max_len
    alone but not behind the vision rows is refused with the reference's
    reason; a request's image of another shape is refused before any
    chunk runs."""
    jcfg, cfg = cfgs
    max_len = PREFIX + 8 + 4
    rep = _port(cfgs, params, lambda cls, v, d: _gen_requests(cls, v, d, [3, 4, 3],
                                                              prompt_len=6),
                max_len=max_len)
    assert rep["requests"] == 3 and rep["generated_tokens"] == 10 and rep["refused"] == []
    assert rep["buckets"] == [8]
    tight = dict(rid="t", tokens=np.zeros(9, np.int32), gen_len=4)
    ours = CostModelAdmission(cfg, 2, max_len, lib=tsl_api.lib("cpu"),
                              policy=BucketPolicy((8, 16), 8))
    ref = JaxAdmission(jcfg, batch=2, max_len=max_len, policy=JaxBucketPolicy((8, 16), 8))
    got, want = ours.admit(Request(**tight), 0.0), ref.admit(JaxRequest(**tight), 0.0)
    assert got == want and not got[0] and "vision prefix 8" in got[1]
    eng = ServeEngine(cfg, batch=2, max_len=max_len, device="cpu", params=params)
    bad = Request(rid="x", tokens=np.arange(6), gen_len=2,
                  embeds=np.zeros((PREFIX + 1, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="vision_prefix 8"):
        eng.run([bad])


# -- fused paged mode --------------------------------------------------------------------


def test_fused_paged_equals_the_reference_and_lane_mode(cfgs, params):
    """tests/test_serve_fused_paged.py:59: decode runs fused straight off
    the pools (the vision rows in the request's first pages), more requests
    resident than lanes; the tokens are the reference engine's, counter for
    counter, and the lane engine's."""
    def requests(cls, v, d):
        return _gen_requests(cls, v, d, [5, 4, 4, 3])

    jrep, rep = _serve(cfgs, params, requests,
                       jax_kw={"paged": JaxPagedConfig(page_size=PAGE)},
                       kw={"paged": PagedConfig(page_size=PAGE)})
    _same(jrep, rep, paged=True)
    paged = rep["paged"]
    assert paged["fused"] and paged["lane_activations"] == 0
    assert paged["tail_restores"] > 0 and paged["resident_requests_peak"] > 2
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}
    assert rep["outputs"] == _port(cfgs, params, requests)["outputs"]


def test_the_prefix_store_shares_only_equal_images(cfgs, params):
    """Four requests of one 16-token prompt at page 8 (an 8-token shareable
    head: the share boundary is 8 vision rows + 8 tokens, two whole pages):
    r1 repeats r0's prompt and image and hits the prefix store,
    reading r0's vision and prompt pages; r2 and r3 carry r0's tokens behind
    another image and miss (r3 then hits r2's entry). Outputs and counts
    equal the reference engine's: a key of the tokens alone would hand r2
    r0's vision rows."""
    def requests(cls, v, d):
        rng = np.random.default_rng(21)
        toks = rng.integers(0, v, 16).astype(np.int32)
        a, b = _image(rng, d), _image(rng, d)
        return [cls(rid=f"r{i}", tokens=toks.copy(), gen_len=4, sla_s=600.0, embeds=e,
                    shared_prefix_len=8) for i, e in enumerate([a, a.copy(), b, b.copy()])]

    jrep, rep = _serve(cfgs, params, requests, max_len=PREFIX + 32,
                       jax_kw={"paged": JaxPagedConfig(page_size=8)},
                       kw={"paged": PagedConfig(page_size=8)})
    _same(jrep, rep, paged=True)
    out = rep["outputs"]
    assert rep["paged"]["prefix_hits"] == 2 and rep["paged"]["prefix_misses"] == 2
    assert out["r0"] == out["r1"] and out["r2"] == out["r3"] and out["r0"] != out["r2"]


# -- speculation ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_ngram_speculation_equals_the_reference_and_plain(cfgs, params, mode):
    """tests/test_serve_spec.py:32 (the vlm family): greedy speculative
    tokens at fixed_k 3 equal the reference engine's and plain decode's; the
    span's rows land past the vision rows (fused: straight in the pools),
    and the verify step writes its own rows (no commit)."""
    jax.clear_caches()
    jkw = {"paged": JaxPagedConfig(page_size=PAGE)} if mode == "fused" else {}
    jcfg = cfgs[0]
    jrep = JaxServeEngine(jcfg, batch=2, max_len=PREFIX + 40, seed=0, admission=False,
                          speculation=JaxSpeculationConfig(fixed_k=3), **jkw).run(
        _spec_requests(JaxRequest, jcfg.vocab, jcfg.d_model))
    kw = {"admission": False, "speculation": SpeculationConfig(fixed_k=3)}
    if mode == "fused":
        kw["paged"] = PagedConfig(page_size=PAGE)
    rep = _port(cfgs, params, _spec_requests, kw=kw, max_len=PREFIX + 40)
    _same(jrep, rep, paged=mode == "fused", spec=True)
    plain = _port(cfgs, params, _spec_requests, kw={"admission": False},
                  max_len=PREFIX + 40)
    assert rep["outputs"] == plain["outputs"]
    assert rep["spec"]["verify_steps"] > 0 and rep["spec"]["accepted_tokens"] > 0
    assert "commit" not in rep["jit_cache"]


# -- admission and the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_admission_prices_vlm_as_the_reference(reduced):
    """n_layers attention reads a decode step; prefill prices every chunk's
    attention at the vision prefix + its fill; the page check counts the
    vision rows: every price the reference scheduler's (256 vision rows at
    full size, 8 reduced)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    policy, jpolicy = BucketPolicy((64, 128), 64), JaxBucketPolicy((64, 128), 64)
    ours = CostModelAdmission(cfg, 8, 512, lib=tsl_api.lib("cpu"), policy=policy)
    ref = JaxAdmission(jcfg, 8, 512, policy=jpolicy)
    assert ours.param_bytes == ref.param_bytes and ours.prefix == cfg.vision_prefix
    assert ours._attn_layers == ref._attn_layers == cfg.n_layers
    for s in (None, 64, 300):
        assert ours.step_seconds(s) * ours.hbm_bw == pytest.approx(
            ref.step_seconds(s) * JAX_HBM_BW)
        for k in (1, 4):
            assert ours.verify_seconds(k, s) * ours.hbm_bw == pytest.approx(
                ref.verify_seconds(k, s) * JAX_HBM_BW)
    for n in (64, 128):
        assert ours.prefill_seconds(n) * ours.peak_flops == pytest.approx(
            ref.prefill_seconds(n) * JAX_PEAK_FLOPS)

    class Budget:
        n_pages, page_bytes = 64, 1

        @staticmethod
        def pages_for_rows(rows):
            return -(-rows // 16)

        @staticmethod
        def pages_free():
            return 20

    for prompt in (40, 120):
        kw = dict(rid="p", tokens=np.zeros(prompt, np.int32), gen_len=8)
        got = PagedAdmission(cfg, 8, 512, lib=tsl_api.lib("cpu"), budget=Budget,
                             policy=policy).admit(Request(**kw), 0.0)
        want = JaxPagedAdmission(jcfg, 8, 512, budget=Budget, policy=jpolicy).admit(
            JaxRequest(**kw), 0.0)
        assert got == want


def test_the_serve_cli_serves_internvl2_reduced():
    """``python -m repro_torch.launch.serve --arch internvl2-2b --reduced``:
    max_len sized for the vision prefix + bucket + gen (as the reference's
    CLI), each request behind its own seeded image; every request answered
    in full."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-len", "12", "--gen-len", "5",
                      "--prefill-chunk", "8"])
    assert out["arch"] == "internvl2-2b-reduced" and out["target"] == "torch_cpu"
    assert out["tokens_per_request"] == {"req0": 5, "req1": 5, "req2": 5}
    assert out["refused"] == [] and out["jit_cache"] == {"prefill_chunk": 2, "decode": 1}
    assert out["report"]["per_request"][0]["prompt_len"] == 12
