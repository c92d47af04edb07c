"""The port's ServeEngine on whisper-tiny --reduced against the JAX reference's
engine, with the reference's params carried across by ``load_jax_params``
and the same requests (each with its own seeded frames, ``enc_len`` 8), all
arriving at once so both engines see the same admission sequence whatever
the host's speed.

Greedy outputs must be equal token for token, and every count the reports
share equal too: the step and admission logs, slot reuse, prefill tokens,
``report["paged"]``'s counters and ``report["spec"]``'s, and ``jit_cache``
in lane mode. Two chunks of one prompt are two compiled entries in both
engines: the first chunk runs the encoder on the request's frames (the
reference's jitted chunk compiles a second entry for it). The cases follow
the reference's tests: a freed slot refilled mid-stream
(``tests/test_serve.py:89-101``), slot surgery (``:251``), fused paged
decode against lane mode (``tests/test_serve_fused_paged.py:56``), int8
pages, n-gram speculation lane and fused (``tests/test_serve_spec.py:31``);
then the engine's refusals, the prefix store keyed by the frames, admission's
prices and the serve CLI."""

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
from repro.serve.paging import prefix_key as jax_prefix_key
from repro.serve.scheduler import HBM_BW as JAX_HBM_BW
from repro.serve.scheduler import PEAK_FLOPS as JAX_PEAK_FLOPS
from repro.serve.scheduler import CostModelAdmission as JaxAdmission
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (CostModelAdmission, PagedConfig, Request, ServeEngine,
                               SpeculationConfig, prefix_key, take_slot, validate_donor)

ARCH = "whisper-tiny"
ENC_LEN = 8
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
def jparams(cfgs):
    """The reference engine's own weights (``init(PRNGKey(seed=0))``)."""
    return jax_build_model(cfgs[0]).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfgs, jparams):
    return load_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], "cpu")


def _frames(rng, d):
    return rng.normal(size=(ENC_LEN, d)).astype(np.float32)


def _gen_requests(cls, vocab, d, gen_lens, prompt_len=8, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(gen_lens):
        toks = rng.integers(0, vocab, prompt_len).astype(np.int32)
        if prefix is not None:
            toks[:len(prefix)] = prefix
        out.append(cls(rid=f"r{i}", tokens=toks, gen_len=g, sla_s=600.0,
                       embeds=_frames(rng, d),
                       shared_prefix_len=None if prefix is None else len(prefix)))
    return out


def _spec_requests(cls, vocab, d):
    """tests/test_serve_spec.py's three requests over 2 slots, with frames."""
    rng = np.random.default_rng(0)
    rnd = rng.integers(1, vocab, 5)
    return [cls(rid="a", tokens=np.array(REPETITIVE), gen_len=9, embeds=_frames(rng, d)),
            cls(rid="b", tokens=rnd, gen_len=6, embeds=_frames(rng, d)),
            cls(rid="c", tokens=np.array(REPETITIVE[:7]), gen_len=8,
                embeds=_frames(rng, d))]


def _port(cfgs, params, requests, *, kw=None, batch=2, max_len=24):
    cfg = cfgs[1]
    return ServeEngine(cfg, batch=batch, max_len=max_len, device="cpu", params=params,
                       enc_len=ENC_LEN, **(kw or {})).run(
        requests(Request, cfg.vocab, cfg.d_model))


def _serve(cfgs, params, requests, *, jax_kw=None, kw=None, batch=2, max_len=24):
    """(reference report, port report): ``requests(cls, vocab, d)`` through
    both engines, the reference with ``jax_kw``, the port with ``kw``."""
    jax.clear_caches()
    jcfg = cfgs[0]
    jrep = JaxServeEngine(jcfg, batch=batch, max_len=max_len, seed=0, enc_len=ENC_LEN,
                          **(jax_kw or {})).run(requests(JaxRequest, jcfg.vocab, jcfg.d_model))
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
    """tests/test_serve.py:89-101 with enc_len 8: batch 2, four requests of
    staggered lengths; a freed slot is refilled before the long neighbour
    finishes (its cross K/V replaced by the new request's)."""
    jrep, rep = _serve(cfgs, params,
                       lambda cls, v, d: _gen_requests(cls, v, d, [4, 12, 6, 12]))
    _same(jrep, rep)
    assert rep["generated_tokens"] == 34 and rep["padded_slot_steps_steady"] == 0
    assert max(rep["slot_reuse"]) >= 2 and rep["sla_hit_rate"] == 1.0
    steps = {e["rid"]: e["step"] for e in rep["admission_log"]}
    assert 0 < steps["r2"] < 12 - 1, steps
    # prompts of one chunk: every chunk is a first chunk, with its frames
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}


def test_two_chunk_prompts_capture_the_first_chunk_apart(cfgs, params):
    """Prompts of 16 tokens (two chunks): the encoder's chunk and the later
    one are two compiled entries, as in the reference."""
    jrep, rep = _serve(cfgs, params,
                       lambda cls, v, d: _gen_requests(cls, v, d, [3, 5, 4], prompt_len=16),
                       max_len=32)
    _same(jrep, rep)
    assert rep["jit_cache"] == {"prefill_chunk": 2, "decode": 1}


def test_slot_surgery_insert_take_reset(cfgs, params, jparams):
    """tests/test_serve.py:251 with enc_len 8: insert_slot grafts a batch-1
    prefill (its self-attention cache and its cross K/V) into one slot and
    leaves the neighbour alone; reset_slot zeroes exactly it."""
    jcfg, cfg = cfgs
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    frames = rng.normal(size=(1, ENC_LEN, cfg.d_model)).astype(np.float32)
    _, want = jax_build_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(frames)}, 12)
    _, donor = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                      "audio_embeds": torch.from_numpy(frames)}, 12)
    for k in donor:
        np.testing.assert_allclose(donor[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-5)
    state = model.init_decode_state(2, 12, enc_len=ENC_LEN)
    for leaf in state.values():
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    axes = model.state_batch_axes(state)
    neighbour = {k: v.clone() for k, v in take_slot(state, axes, 0).items()}
    validate_donor(state, donor, axes)
    model.insert_slot(state, donor, 1)
    for k, v in take_slot(state, axes, 1).items():
        assert torch.equal(v, donor[k])
    for k, v in take_slot(state, axes, 0).items():
        assert torch.equal(v, neighbour[k])
    model.reset_slot(state, 1)
    assert all(torch.count_nonzero(v) == 0 for v in take_slot(state, axes, 1).values())


def test_refuses_a_missing_enc_len_and_a_donor_of_another(cfgs, params):
    """The engine requires enc_len for the audio family (as the
    reference's); a donor whose cross K/V have another encoder length is
    refused before any insert, and a request's frames of another length
    before any chunk runs."""
    jcfg, cfg = cfgs
    with pytest.raises(ValueError, match="enc_len"):
        ServeEngine(cfg, batch=2, max_len=24, device="cpu", params=params)
    with pytest.raises(ValueError, match="enc_len"):
        JaxServeEngine(jcfg, batch=2, max_len=24)
    model = build_model(cfg, device="cpu")
    state = model.init_decode_state(2, 24, enc_len=ENC_LEN)
    donor = model.init_decode_state(1, 24, enc_len=ENC_LEN + 4)
    with pytest.raises(ValueError, match="cross_k"):
        validate_donor(state, donor, model.state_batch_axes(state))
    validate_donor(state, model.init_decode_state(1, 24, enc_len=ENC_LEN),
                   model.state_batch_axes(state))
    eng = ServeEngine(cfg, batch=2, max_len=24, device="cpu", params=params, enc_len=ENC_LEN)
    bad = Request(rid="x", tokens=np.arange(6), gen_len=2,
                  embeds=np.zeros((ENC_LEN + 1, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="frames"):
        eng.run([bad])


def test_requests_without_frames_serve_zeros(cfgs, params):
    """A request that carries no frames is served over zeros (the
    reference's ``_first_chunk_embeds``), as the serve CLI's are."""
    def requests(cls, v, d):
        out = _gen_requests(cls, v, d, [4, 5])
        out[1].embeds = None
        return out

    jrep, rep = _serve(cfgs, params, requests)
    _same(jrep, rep)


# -- fused paged mode, int8 pages -------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["full", "int8"])
def test_fused_paged_equals_the_reference_and_lane_mode(cfgs, params, int8):
    """tests/test_serve_fused_paged.py:56 (whisper, enc_len 8): decode runs
    fused (the cross K/V tails in the slot table, the self-attention straight
    off the pools), more requests resident than lanes, and the tokens are
    the lane engine's; on int8 pages the reference engine's, counter for
    counter."""
    def requests(cls, v, d):
        return _gen_requests(cls, v, d, [5, 4, 4, 3])

    jrep, rep = _serve(cfgs, params, requests,
                       jax_kw={"paged": JaxPagedConfig(page_size=PAGE, int8=int8)},
                       kw={"paged": PagedConfig(page_size=PAGE, int8=int8)})
    _same(jrep, rep, paged=True)
    paged = rep["paged"]
    assert paged["fused"] and paged["int8"] == int8 and paged["lane_activations"] == 0
    assert paged["tail_restores"] > 0 and paged["resident_requests_peak"] > 2
    assert rep["jit_cache"] == {"prefill_chunk": 1, "decode": 1}
    if not int8:
        assert rep["outputs"] == _port(cfgs, params, requests)["outputs"]


def test_the_prefix_store_shares_only_equal_frames(cfgs, params):
    """Four requests of one 16-token prompt (an 8-token shareable prefix):
    r1 repeats r0's prompt and frames (a clip transcribed twice) and hits
    the prefix store, restoring r0's cross K/V from the entry's tail; r2 and
    r3 carry r0's tokens with other frames and miss (r3 then hits r2's
    entry: it repeats r2's frames). Outputs and counts equal the reference
    engine's, lane and fused paged: a key of the tokens alone would hand r2
    r0's cross K/V, and r2's tokens would be r0's."""
    def requests(cls, v, d):
        rng = np.random.default_rng(21)
        toks = rng.integers(0, v, 16).astype(np.int32)
        a, b = _frames(rng, d), _frames(rng, d)
        frames = [a, a.copy(), b, b.copy()]
        return [cls(rid=f"r{i}", tokens=toks.copy(), gen_len=4, sla_s=600.0, embeds=f,
                    shared_prefix_len=8) for i, f in enumerate(frames)]

    jrep, rep = _serve(cfgs, params, requests, max_len=32,
                       jax_kw={"paged": JaxPagedConfig(page_size=PAGE)},
                       kw={"paged": PagedConfig(page_size=PAGE)})
    _same(jrep, rep, paged=True)
    out = rep["outputs"]
    assert rep["paged"]["prefix_hits"] == 2 and rep["paged"]["prefix_misses"] == 2
    assert out["r0"] == out["r1"] and out["r2"] == out["r3"] and out["r0"] != out["r2"]
    assert out == _port(cfgs, params, requests, max_len=32)["outputs"]


def test_prefix_key_hashes_the_frames():
    """The reference's digest, key for key, with and without frames; equal
    tokens with other frames give another key, and a token-only key is
    unchanged by the new keyword's default."""
    base = dict(arch=ARCH, page_size=PAGE, int8=False, seed=0, tokens=[1, 2, 3])
    a = np.random.default_rng(0).normal(size=(ENC_LEN, 4)).astype(np.float32)
    b = a + np.float32(1e-3)
    assert prefix_key(**base) == jax_prefix_key(**base, prefix_rows=0)
    assert prefix_key(**base) == prefix_key(**base, prefix_rows=0, embeds=None)
    for e in (a, b):
        assert prefix_key(**base, embeds=e) == jax_prefix_key(**base, prefix_rows=0, embeds=e)
    assert len({prefix_key(**base), prefix_key(**base, embeds=a),
                prefix_key(**base, embeds=b)}) == 3
    assert prefix_key(**base, embeds=a) == prefix_key(**base, embeds=a.copy())


# -- speculation ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_spec(cfgs, params):
    """The port's plain (no speculation) outputs on the speculation requests."""
    return _port(cfgs, params, _spec_requests, kw={"admission": False},
                 max_len=48)["outputs"]


@pytest.mark.parametrize("mode", ["lane", "fused"])
@pytest.mark.parametrize("kind", ["fixed_k3", "priced"])
def test_ngram_speculation_equals_the_reference_and_plain(cfgs, params, plain_spec, kind,
                                                          mode):
    """tests/test_serve_spec.py:31 (the audio family): greedy speculative
    tokens equal plain decode's and the reference engine's; the verify span
    scores cross-attention row by row against the cross K/V (fused: the
    self-attention off the pools), and writes its own rows (no commit)."""
    jax.clear_caches()
    spec = JaxSpeculationConfig(fixed_k=3) if kind == "fixed_k3" else JaxSpeculationConfig()
    jkw = {"paged": JaxPagedConfig(page_size=PAGE)} if mode == "fused" else {}
    jcfg = cfgs[0]
    jrep = JaxServeEngine(jcfg, batch=2, max_len=48, seed=0, admission=False,
                          enc_len=ENC_LEN, speculation=spec, **jkw).run(
        _spec_requests(JaxRequest, jcfg.vocab, jcfg.d_model))
    kw = {"admission": False,
          "speculation": SpeculationConfig(fixed_k=3) if kind == "fixed_k3"
          else SpeculationConfig()}
    if mode == "fused":
        kw["paged"] = PagedConfig(page_size=PAGE)
    rep = _port(cfgs, params, _spec_requests, kw=kw, max_len=48)
    _same(jrep, rep, paged=mode == "fused", spec=True)
    assert rep["outputs"] == plain_spec
    cache = rep["jit_cache"]
    assert "commit" not in cache and "commit_paged" not in cache
    if kind == "fixed_k3":
        assert rep["spec"]["verify_steps"] > 0 and cache["verify"] > 0
        if mode == "fused":
            assert rep["paged"]["fused"] and rep["paged"]["verify_steps"] > 0


# -- admission and the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_admission_prices_whisper_as_the_reference(reduced):
    """Two attention reads a decoder layer, one of them at the fixed enc_len
    (1500 frames at full size, 8 reduced); a verify step pays no commit;
    prefill prices 2 x n_layers attention layers over the chunk schedule:
    every price the reference scheduler's."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    enc_len = 1500
    if reduced:
        jcfg, cfg, enc_len = jcfg.reduced(), cfg.reduced(), ENC_LEN
    ours = CostModelAdmission(cfg, 8, 320, lib=tsl_api.lib("cpu"), enc_len=enc_len)
    ref = JaxAdmission(jcfg, 8, 320, enc_len=enc_len)
    assert ours.param_bytes == ref.param_bytes
    assert ours._attn_layers == ref._attn_layers == 2 * cfg.n_layers
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
    # the cross K/V at enc_len, not at the fill: a fill of 64 still pays them
    no_cross = CostModelAdmission(cfg, 8, 320, lib=tsl_api.lib("cpu"), enc_len=0)
    assert ours.decode_bytes_per_step(64) > no_cross.decode_bytes_per_step(64)


def test_the_serve_cli_serves_whisper_reduced():
    """``python -m repro_torch.launch.serve --arch whisper-tiny --reduced``:
    enc_len = the prompt length and zero frames, as the reference's CLI
    (``repro/launch/serve.py:71``); every request answered in full."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-len", "12", "--gen-len", "5",
                      "--prefill-chunk", "8"])
    assert out["arch"] == "whisper-tiny-reduced" and out["target"] == "torch_cpu"
    assert out["tokens_per_request"] == {"req0": 5, "req1": 5, "req2": 5}
    assert out["refused"] == [] and out["jit_cache"] == {"prefill_chunk": 2, "decode": 1}
    assert out["report"]["per_request"][0]["prompt_len"] == 12
