"""The port's lane-mode ServeEngine against the JAX reference's, on
qwen1.5-0.5b --reduced with the same params and the same requests.

Greedy outputs must be equal token for token (report["outputs"]); both
engines must run with zero padded slot steps in steady state; more requests
than slots exercises mid-stream slot reuse. Scheduler and admission units
check the host control plane on its own."""

import jax
import torch
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.serve import CostModelAdmission as JaxAdmission
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.nn.model import load_jax_params
from repro_torch.serve import (BucketPolicy, CostModelAdmission, Request, Scheduler,
                               ServeEngine, scheduler)

ARCH = "qwen1.5-0.5b"
BATCH, MAX_LEN, CHUNK = 2, 40, 4
# (prompt_len, gen_len): more requests than slots, ragged prompts and gens
SPECS = [(5, 6), (12, 3), (9, 8), (3, 1), (16, 5)]


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=f"r{i}", tokens=rng.integers(0, vocab, p).astype(np.int32), gen_len=g)
            for i, (p, g) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def reports():
    jcfg = jax_get_config(ARCH).reduced()
    jeng = JaxServeEngine(jcfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                          prefill_chunk=CHUNK)
    jrep = jeng.run(_requests(JaxRequest, jcfg.vocab))
    cfg = get_config(ARCH).reduced()
    params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu", params=params,
                      prefill_chunk=CHUNK)
    rep = eng.run(_requests(Request, cfg.vocab))
    return jrep, rep


def test_greedy_outputs_match_the_reference_token_for_token(reports):
    jrep, rep = reports
    assert rep["outputs"] == jrep["outputs"]
    for i, (_, gen) in enumerate(SPECS):
        assert len(rep["outputs"][f"r{i}"]) == gen


def test_continuous_batching_without_padded_steps(reports):
    jrep, rep = reports
    assert rep["padded_slot_steps_steady"] == jrep["padded_slot_steps_steady"] == 0
    assert rep["requests"] == len(SPECS) and not rep["refused"]
    assert sum(rep["slot_reuse"]) == len(SPECS) > BATCH   # slots were reused mid-stream
    assert rep["buckets"] == jrep["buckets"]
    assert rep["prefill_tokens"] == jrep["prefill_tokens"]
    assert set(rep) >= set(jrep) - {"jit_cache"}


def test_sampled_requests_run_and_stay_in_vocab():
    cfg = get_config(ARCH).reduced()
    from repro_torch.serve import SamplingConfig

    eng = ServeEngine(cfg, batch=2, max_len=24, device="cpu", seed=3,
                      sampling=SamplingConfig(temperature=0.8, top_k=5), prefill_chunk=8)
    rep = eng.run(_requests(Request, cfg.vocab)[:3])
    toks = [t for out in rep["outputs"].values() for t in out]
    assert len(toks) == sum(g for _, g in SPECS[:3])
    assert all(0 <= t < cfg.vocab for t in toks)


def test_admission_prices_like_the_reference_with_the_sru_roofline():
    """Bytes and flops come from the same UPD cost terms as the reference;
    seconds divide by the port's target SRU, not the TPU constants."""
    jcfg = jax_get_config("qwen1.5-0.5b")
    cfg = get_config("qwen1.5-0.5b")
    policy = BucketPolicy((64, 128, 256), 64)
    lib = tsl_api.lib("cpu")
    ours = CostModelAdmission(cfg, 8, 320, lib=lib, policy=policy)
    ref = JaxAdmission(jcfg, 8, 320, policy=policy)
    assert ours.decode_bytes_per_step() == pytest.approx(ref.decode_bytes_per_step())
    assert ours.step_seconds() == pytest.approx(
        ours.decode_bytes_per_step() / lib.TARGET.hbm_bw)
    assert ours.hbm_bw == 5.0e10 and ours.peak_flops == 1.0e12   # torch_cpu SRU
    req = Request(rid="x", tokens=np.zeros(300, np.int32), gen_len=8)
    ok, reason = ours.admit(req, 0.0)
    assert not ok and reason.startswith("over_budget")
    req = Request(rid="y", tokens=np.zeros(200, np.int32), gen_len=8, sla_s=1e-6)
    ok, reason = ours.admit(req, 0.0)
    assert not ok and reason.startswith("sla_infeasible")


def test_missing_serve_block_raises(monkeypatch):
    class _Prim:
        extra = {}

    class _Corpus:
        primitives = {"attention_prefill_chunk": _Prim()}

    import repro_torch.core as core

    monkeypatch.setattr(core, "load_corpus", lambda: _Corpus())
    with pytest.raises(KeyError, match="serve"):
        scheduler.upd_serve_defaults()


def test_scheduler_lifecycle_and_time_attribution():
    sched = Scheduler(2)
    reqs = [Request(rid=f"q{i}", tokens=np.zeros(4, np.int32), gen_len=2) for i in range(3)]
    for r in reqs:
        sched.submit(r, 1.0)
    assert sched.free_slots() == [0, 1]
    a = sched.next_admissible(1.0)
    sched.reserve(0, a, step=0)
    sched.place(a, 0)
    sched.first_token(0, 1.5)
    assert sched.active_slots() == [0] and not sched.slot_done(0)
    pre, dec = sched.attribute_step_time(1.0, prefill_tokens=3, decode_slots=[0])
    assert pre == pytest.approx(0.75) and dec == pytest.approx(0.25)
    sched.step_done(0)
    assert sched.slot_done(0)
    m = sched.finish(0, 2.0)
    assert m.tokens_out == 2 and m.latency_s == pytest.approx(1.0)
    assert sched.free_slots() == [0, 1] and sched.has_work()


def test_take_slot_and_validate_donor():
    from repro_torch.nn.model import build_model
    from repro_torch.serve import take_slot, validate_donor

    model = build_model(get_config(ARCH).reduced(), device="cpu")
    state = model.init_decode_state(3, 16)
    axes = model.state_batch_axes(state)
    donor = model.init_decode_state(1, 16)
    donor["k"].fill_(2.0)
    validate_donor(state, donor, axes)
    model.insert_slot(state, donor, 2)
    assert bool((take_slot(state, axes, 2)["k"] == 2.0).all())
    assert torch.count_nonzero(take_slot(state, axes, 1)["k"]) == 0
    with pytest.raises(ValueError, match="incompatible"):
        validate_donor(state, model.init_decode_state(1, 24), axes)
    with pytest.raises(ValueError, match="incompatible"):
        validate_donor(state, model.init_decode_state(2, 16), axes)
