"""``ServeEngine.submit()``: requests handed to a RUNNING ``run()`` from
another thread (the reference's ``_inbox``, ``repro/serve/engine.py``), on
reduced qwen1.5-0.5b, float32, on the host.

- From a thread, at seeded Poisson times while the first requests decode:
  every valid request is answered with the tokens an all-at-once run of the
  same requests gives (greedy), in lane and fused paged mode; a duplicate
  rid and a ``gen_len`` of 0 are recorded refusals, and the loop serves the
  others.
- The refusals' reasons equal the reference engine's for the same
  submissions (made before ``run()``, so both engines drain them at their
  first step: a deterministic comparison).
- A request submitted when no loop runs waits for the next ``run()``.
- Stress: more submitting threads than cores, a shortened switch interval:
  no submission is lost (each is answered by the running loop or by the
  next ``run()``)."""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.nn.model import load_jax_params
from repro_torch.serve import PagedConfig, Request, ServeEngine

ARCH = "qwen1.5-0.5b"
N_FIRST, N_STREAMED, GEN_FIRST, GEN_STREAMED = 3, 5, 32, 6


def _requests(cls, vocab):
    """The first N_FIRST requests decode GEN_FIRST tokens (the loop stays busy
    while the rest arrive); the others share an 8-token prefix."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, 8)
    out = []
    for i in range(N_FIRST + N_STREAMED):
        toks = np.concatenate([prefix, rng.integers(0, vocab, 8)]).astype(np.int32)
        out.append(cls(rid=f"q{i}", tokens=toks,
                       gen_len=GEN_FIRST if i < N_FIRST else GEN_STREAMED))
    return out


def _invalid(cls, vocab):
    toks = np.arange(16, dtype=np.int32) % vocab
    return [cls(rid="q1", tokens=toks, gen_len=4),          # duplicate rid
            cls(rid="zero", tokens=toks, gen_len=0)]


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    jax.clear_caches()
    jcfg = jax_get_config(ARCH).reduced()
    jeng = JaxServeEngine(jcfg, batch=2, max_len=64, seed=0)
    params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    return cfg, jcfg, jeng, params


def _engine(cfg, params, mode):
    kw = {"paged": PagedConfig(page_size=8)} if mode == "fused" else {}
    return ServeEngine(cfg, batch=2, max_len=64, device="cpu", params=params, **kw)


@pytest.mark.parametrize("mode", ["lane", "fused"])
def test_submit_from_a_thread_equals_all_at_once(setup, mode):
    cfg, _, _, params = setup
    reqs = _requests(Request, cfg.vocab)
    want = _engine(cfg, params, mode).run(_requests(Request, cfg.vocab))

    engine = _engine(cfg, params, mode)
    gaps = np.random.default_rng(7).exponential(0.002, N_STREAMED + 2)
    gaps[0] += 0.02                 # after the loop has begun

    def feed():
        for gap, r in zip(gaps, reqs[N_FIRST:] + _invalid(Request, cfg.vocab)):
            time.sleep(gap)
            engine.submit(r)

    thread = threading.Thread(target=feed)
    thread.start()
    got = engine.run(reqs[:N_FIRST])
    thread.join(timeout=30)
    assert not thread.is_alive() and not engine._inbox
    assert got["outputs"] == want["outputs"]
    assert len(got["outputs"]) == N_FIRST + N_STREAMED
    assert got["refused"] == [
        {"rid": "q1", "reason": "invalid: duplicate rid in this run"},
        {"rid": "zero", "reason": "invalid: gen_len must be >= 1 (the first token "
                                  "always comes from prefill)"}]
    admitted = {m["rid"]: m["admitted_at_step"] for m in got["per_request"]}
    # the streamed requests arrived while the first ones were running
    assert max(admitted[r.rid] for r in reqs[N_FIRST:]) > 0
    if mode == "fused":
        assert got["paged"]["prefix_hits"] > 0


def test_refusal_reasons_equal_the_reference(setup):
    cfg, jcfg, jeng, params = setup
    for r in _invalid(JaxRequest, jcfg.vocab):
        jeng.submit(r)
    jrep = jeng.run(_requests(JaxRequest, jcfg.vocab)[:N_FIRST])
    engine = _engine(cfg, params, "lane")
    for r in _invalid(Request, cfg.vocab):
        engine.submit(r)
    rep = engine.run(_requests(Request, cfg.vocab)[:N_FIRST])
    assert rep["refused"] == jrep["refused"] and len(rep["refused"]) == 2
    assert rep["outputs"] == jrep["outputs"]


def test_a_submit_between_runs_waits_for_the_next_run(setup):
    cfg, _, _, params = setup
    engine = _engine(cfg, params, "lane")
    reqs = _requests(Request, cfg.vocab)
    first = engine.run(reqs[:1])
    engine.submit(reqs[1])
    second = engine.run([])
    assert set(first["outputs"]) == {"q0"} and set(second["outputs"]) == {"q1"}
    assert len(second["outputs"]["q1"]) == GEN_FIRST


def test_concurrent_submits_lose_no_request(setup):
    cfg, _, _, params = setup
    engine = _engine(cfg, params, "lane")
    n_threads = (os.cpu_count() or 1) + 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (n_threads, 2, 8)).astype(np.int32)
    go = threading.Barrier(n_threads)

    def feed(t):
        go.wait(timeout=30)
        for j in range(2):
            engine.submit(Request(rid=f"t{t}-{j}", tokens=toks[t, j], gen_len=1))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=feed, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        got = engine.run(_requests(Request, cfg.vocab)[:1])
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        rest = engine.run([])
    finally:
        sys.setswitchinterval(old)
    want = {f"t{t}-{j}" for t in range(n_threads) for j in range(2)} | {"q0"}
    assert set(got["outputs"]) | set(rest["outputs"]) == want
    assert not set(got["outputs"]) & set(rest["outputs"])
    assert not got["refused"] and not rest["refused"] and not engine._inbox
