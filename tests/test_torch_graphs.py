"""The port's compiled serving steps (``repro_torch/serve/graphs.py``), the
counterpart of the reference engine's jitted steps, on reduced qwen1.5-0.5b.

On the host a step runs eagerly against the static buffers a captured graph
would hold, so these tests exercise what the card's replays share with it:

- ``report["jit_cache"]`` has exactly the reference's keys, within the
  reference's bound (``tests/test_serve_chunked.py``: prefill_chunk + decode
  <= len(buckets) + 1) and verify <= k_max;
- outputs and every report counter are the same with and without
  ``disable_graphs()``, in lane, fused paged and speculative paged modes
  (the draft-model drafter's own steps included);
- a chunk's logits row survives a later chunk of another request, whose
  replay overwrites the static logits;
- the chunk with a (1,) device fill equals the int-fill path and the
  reference's ``prefill_chunk``;
- the fixed workspace of a fused paged step is the paged kernel's
  B * KH * splits * rows * (D + 4) words and B * KH tickets at MAX_SPLITS,
  and ``common.workspace`` neither grows it nor allocates while capturing;
- a replay adds the launches its capture recorded to the counters, and the
  capture adds none (a fake runner in place of the CUDA graph)."""

import contextlib

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
from repro_torch.kernels import common, launch_counters
from repro_torch.kernels.paged import kernel as paged_kernel
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.serve import (PagedConfig, Request, ServeEngine, SpeculationConfig,
                               StepGraphs, disable_graphs)
from repro_torch.serve.engine import _PrefillTask

ARCH = "qwen1.5-0.5b"
BATCH, MAX_LEN, CHUNK, BUCKETS = 2, 40, 4, (4, 8, 16)
# (prompt_len, gen_len): prompts in all three buckets, more requests than
# slots, a repeated pattern the n-gram drafter finds
SPECS = [(3, 5), (7, 6), (12, 4), (5, 7)]
MODES = {
    "lane": {},
    "fused": {"paged": "fused"},
    "spec_fused": {"paged": "fused", "spec": "ngram"},
    "spec_lane_draft_model": {"spec": "draft_model"},
}
# report entries that are counts, not times
COUNTED = ("requests", "generated_tokens", "steps", "padded_slot_steps_steady",
           "prefill_tokens", "slot_reuse", "refused", "step_log", "outputs", "buckets")
PER_REQUEST = ("rid", "slot", "prompt_len", "bucket", "gen_len", "tokens_out",
               "preemptions", "admitted_at_step", "spec_proposed", "spec_accepted",
               "verify_rounds")


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    out = []
    for i, (p, g) in enumerate(SPECS):
        toks = np.resize(rng.integers(0, vocab, 3), p) if i % 2 else rng.integers(0, vocab, p)
        out.append(cls(rid=f"g{i}", tokens=np.asarray(toks, np.int32), gen_len=g))
    return out


def _engine_kw(mode: str, framework: str) -> dict:
    m = MODES[mode]
    kw = {}
    if framework == "jax":
        if "paged" in m:
            kw["paged"] = JaxPagedConfig(fused=True)
        if "spec" in m:
            kw["speculation"] = JaxSpeculationConfig(
                drafter=m["spec"], fixed_k=3,
                draft_arch=ARCH if m["spec"] == "draft_model" else None)
        return kw
    if "paged" in m:
        kw["paged"] = PagedConfig(fused=True)
    if "spec" in m:
        kw["speculation"] = SpeculationConfig(
            drafter=m["spec"], fixed_k=3,
            draft_arch=ARCH if m["spec"] == "draft_model" else None)
    return kw


def _counted(rep: dict) -> dict:
    out = {k: rep[k] for k in COUNTED}
    out["per_request"] = [{k: m[k] for k in PER_REQUEST} for m in rep["per_request"]]
    for k in ("paged", "spec"):
        if k in rep:
            out[k] = rep[k]
    return out


@pytest.fixture(scope="module")
def runs():
    """Per mode: the reference's report, and the port's with graphs and
    under disable_graphs() (two engines on the same params)."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    out = {}
    for mode in MODES:
        jax.clear_caches()
        jeng = JaxServeEngine(jcfg, batch=BATCH, max_len=MAX_LEN, seed=0,
                              prefill_chunk=CHUNK, buckets=BUCKETS,
                              **_engine_kw(mode, "jax"))
        jrep = jeng.run(_requests(JaxRequest, jcfg.vocab))
        params = load_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
        draft = None
        if jeng._drafter is not None and hasattr(jeng._drafter, "params"):
            draft = load_jax_params(jax.tree.map(np.asarray, jeng._drafter.params), cfg,
                                    "cpu")

        def engine():
            return ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu",
                               params=params, prefill_chunk=CHUNK, buckets=BUCKETS,
                               draft_params=draft, **_engine_kw(mode, "torch"))
        eng = engine()
        rep = eng.run(_requests(Request, cfg.vocab))
        with disable_graphs():
            eager = engine().run(_requests(Request, cfg.vocab))
        out[mode] = {"jax": jrep, "graphs": rep, "eager": eager, "engine": eng}
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_jit_cache_has_the_reference_keys_within_its_bound(runs, mode):
    r = runs[mode]
    jc, jjc = r["graphs"]["jit_cache"], r["jax"]["jit_cache"]
    assert set(jc) == set(jjc)
    assert jc["prefill_chunk"] + jc["decode"] <= len(r["graphs"]["buckets"]) + 1, jc
    assert jc["prefill_chunk"] == 1
    if "spec" not in MODES[mode]:
        assert jc["decode"] == 1
    else:
        # fixed_k=3 may leave no step without drafts: no decode entry then
        assert jc["decode"] == int(r["graphs"]["spec"]["decode_steps"] > 0)
        k_max = r["graphs"]["spec"]["k_max"]
        assert 1 <= jc["verify"] <= k_max, jc
        assert r["graphs"]["spec"]["verify_steps"] > 0
    # disable_jit's counterpart compiles nothing
    assert all(v == 0 for v in r["eager"]["jit_cache"].values())
    assert set(r["eager"]["jit_cache"]) == set(jjc)


@pytest.mark.parametrize("mode", list(MODES))
def test_outputs_and_counters_do_not_depend_on_graphs(runs, mode):
    r = runs[mode]
    assert _counted(r["graphs"]) == _counted(r["eager"])
    assert r["graphs"]["outputs"] == r["jax"]["outputs"]
    for k in ("paged", "spec"):
        assert (k in r["graphs"]) == (k in r["jax"])


def test_the_draft_models_steps_are_its_own_entries(runs):
    eng = runs["spec_lane_draft_model"]["engine"]
    assert eng._drafter.graphs.sizes(("prefill_chunk", "decode")) == \
        {"prefill_chunk": 1, "decode": 1}
    # the drafter's decode step is at its own batch and state_len
    step = eng._drafter.graphs.steps["decode", 1]
    assert step.specs["tokens"][0] == (BATCH, 1)
    assert eng._drafter.state["k"].shape[3] == MAX_LEN + eng._k_max


def test_a_chunks_logits_survive_a_later_chunk_of_another_request():
    cfg = get_config(ARCH).reduced()
    eng = ServeEngine(cfg, batch=BATCH, max_len=MAX_LEN, device="cpu", prefill_chunk=CHUNK)
    rng = np.random.default_rng(4)

    def task(padded):
        req = Request(rid="x", tokens=padded[0], gen_len=1)
        return _PrefillTask(req=req, slot=0, padded=padded, n_chunks=1,
                            donor=eng._new_donor())

    pa, pb = (rng.integers(0, cfg.vocab, (1, CHUNK)).astype(np.int64) for _ in range(2))
    a, b, eager = task(pa), task(pb), task(pa)
    with disable_graphs():
        want = eng._chunk(eager, pa, CHUNK)
    got_a = eng._chunk(a, pa, CHUNK)
    got_b = eng._chunk(b, pb, CHUNK)
    static = eng._graphs.steps["prefill_chunk", CHUNK].output
    assert torch.equal(static[:, CHUNK - 1], got_b)      # the next chunk overwrote it
    assert not torch.equal(got_a, got_b)
    assert torch.equal(got_a, want)
    for leaf in ("k", "v"):                              # staged out to each donor
        assert torch.equal(a.donor[leaf], eager.donor[leaf])


def test_chunk_with_a_device_fill_equals_the_int_fill_and_the_reference():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 12)).astype(np.int32)
    jstate = jmodel.init_decode_state(1, 16)
    by_int, by_tensor = model.init_decode_state(1, 16), model.init_decode_state(1, 16)
    for c0 in range(0, 12, CHUNK):
        seg = toks[:, c0:c0 + CHUNK]
        jl, jstate = jmodel.prefill_chunk(jparams, jstate, jnp.asarray(seg), c0, c0,
                                          n_real=CHUNK)
        li, _ = model.prefill_chunk(params, by_int, torch.from_numpy(seg), c0)
        lt, _ = model.prefill_chunk(params, by_tensor, torch.from_numpy(seg),
                                    torch.tensor([c0]))
        assert torch.equal(li, lt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(jl, np.float32),
                                   atol=1e-4, rtol=1e-4)
    for leaf in ("k", "v"):
        assert torch.equal(by_int[leaf], by_tensor[leaf])


@pytest.mark.parametrize("b,h,kh,sq,d,splits", [(8, 16, 16, 1, 64, 1), (8, 16, 16, 5, 64, 7),
                                                (1, 40, 8, 1, 128, 13), (2, 4, 2, 4, 64, 64)])
def test_the_paged_workspace_size(b, h, kh, sq, d, splits):
    assert paged_kernel.workspace_size(b, h, kh, sq, d, splits) == \
        (b * kh * splits * (h // kh) * sq * (d + 4), b * kh)
    assert paged_kernel.workspace_size(b, h, kh, sq, d) == \
        paged_kernel.workspace_size(b, h, kh, sq, d, paged_kernel.MAX_SPLITS)


def test_a_fused_steps_fixed_workspace_fits_every_plan(runs):
    cfg = get_config(ARCH).reduced()
    steps = {**runs["fused"]["engine"]._graphs.steps,
             **runs["spec_fused"]["engine"]._graphs.steps}
    assert ("decode", 1) in steps and ("verify", 4) in steps
    for (kind, width), step in steps.items():
        if kind == "prefill_chunk":
            assert not step.workspaces
            continue
        words = BATCH * cfg.n_kv_heads * paged_kernel.MAX_SPLITS \
            * (cfg.n_heads // cfg.n_kv_heads) * width * (cfg.hd + 4)
        ws, tickets = step.workspaces["paged_attention"]
        assert ws.numel() == words and ws.dtype == torch.float32
        assert tickets.numel() == BATCH * cfg.n_kv_heads and not tickets.any()


def test_workspace_is_fixed_inside_a_step_and_refused_while_capturing(monkeypatch):
    cpu = torch.device("cpu")
    spaces = {"paged_attention": common.allocate_workspace(cpu, 100, 4)}
    with common.fixed_workspaces(spaces):
        ws, ct = common.workspace("paged_attention", cpu, 100, 4)
        assert ws is spaces["paged_attention"][0] and ct is spaces["paged_attention"][1]
        with pytest.raises(ValueError, match="fixed workspace"):
            common.workspace("paged_attention", cpu, 101, 4)
        # a kernel the step did not declare gets its buffer at the warm-up
        hw, _ = common.workspace("hadd", cpu, 8, 2)
        assert spaces["hadd"][0] is hw
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    cuda = torch.device("cuda")
    with common.fixed_workspaces({}), pytest.raises(RuntimeError, match="capturing"):
        common.workspace("paged_attention", cuda, 100, 4)
    with pytest.raises(RuntimeError, match="capturing"):
        common.workspace("paged_attention", cuda, 100, 4)


class _FakeRunner:
    """Stands for CudaGraphRunner: capture runs the body's Python once (as
    CUDA capture does, launching nothing), replay runs none."""

    def __init__(self):
        self.captured = self.replayed = 0

    @contextlib.contextmanager
    def side_stream(self):
        yield

    def capture(self, fn):
        self.captured += 1
        return "graph", fn()

    def replay(self, graph):
        assert graph == "graph"
        self.replayed += 1


def test_a_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    counters = launch_counters()
    for fn in counters.values():
        monkeypatch.setattr(fn, "launches", 0)

    def body(x):
        # stands for a step whose kernels launch twice and once
        counters["rmsnorm"].launches += 2
        counters["paged_attention"].launches += 1
        return x * 2

    runner = _FakeRunner()
    graphs = StepGraphs("cpu", runner=runner)
    x = np.arange(3, dtype=np.float32)

    def call():
        return graphs.step("decode", 1, body, {"x": x})(x=x)

    out = call()                      # the warm-up (counted) and the capture (not)
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0]))
    assert (counters["rmsnorm"].launches, counters["paged_attention"].launches) == (2, 1)
    assert graphs.steps["decode", 1].launches == {"rmsnorm": 2, "paged_attention": 1}
    assert runner.captured == 1 and runner.replayed == 0
    call()
    call()
    assert runner.captured == 1 and runner.replayed == 2
    assert (counters["rmsnorm"].launches, counters["paged_attention"].launches) == (6, 3)
    assert graphs.sizes(("decode", "verify")) == {"decode": 1, "verify": 0}
    with disable_graphs():            # eager: the body itself runs, no replay
        call()
    assert runner.replayed == 2 and counters["rmsnorm"].launches == 8
    with pytest.raises(ValueError, match="static buffer"):
        graphs.steps["decode", 1](x=np.arange(4, dtype=np.float32))
