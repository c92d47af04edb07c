"""The port's rwkv family (RWKV6, Finch) against the JAX reference's, on the
same numpy inputs: the five primitives it adds to the corpus, the model on
the reference's params, and chunked prefill.

Tolerances (float32 throughout, TF32 irrelevant on the host):

- primitives: 1e-5 absolute + 1e-5 relative against ``repro.kernels.wkv6``
  and ``load_library("cpu_xla")`` (summation orders differ; the chunked form
  against the time-step scan 2e-5, its log-space decay products rounding
  once more);
- the reduced model (2 layers, d 64, 4 WKV heads of 16): logits and state
  leaves within 2e-5 absolute + 1e-5 relative of the reference's, greedy
  tokens identical; chunked prefill against whole-prompt prefill within the
  reference test's 2e-4 (``tests/test_serve_chunked.py``);
- a sequence with no real row in a chunk or a commit: bit-identical."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.wkv6 import ops as jax_wkv6_ops
from repro.kernels.wkv6 import ref as jax_wkv6_ref
from repro.nn.model import build_model as jax_build_model
from repro.serve.scheduler import CostModelAdmission as JaxAdmission
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.configs.arch import ArchConfig
from repro_torch.core import load_library
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.nn.model import RwkvModel, build_model, load_jax_params
from repro_torch.serve import CostModelAdmission
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_train_step

ARCH = "rwkv6-7b"
ATOL = RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 2e-5, 1e-5
CHUNKED_TOL = 2e-5
CHUNK_TOL = 2e-4                  # the reference's own chunked-prefill bar


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _wkv_inputs(t=37, b=2, h=3, k=8, seed=0):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.7, 0.999, (b, t, h, k)).astype(np.float32)
    u = rng.normal(size=(h, k)).astype(np.float32)
    s0 = rng.normal(size=(b, h, k, k)).astype(np.float32)
    return (r, kk, v, w, u), s0


# -- (a) the primitives ---------------------------------------------------------


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_scan_matches_the_reference_scan(with_s0):
    args, s0 = _wkv_inputs()
    jy, js = jax_wkv6_ref.wkv6_scan(*map(jnp.asarray, args),
                                    s0=jnp.asarray(s0) if with_s0 else None)
    y, s = wkv6_ref.wkv6_scan(*map(torch.from_numpy, args),
                              s0=torch.from_numpy(s0) if with_s0 else None)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_wkv6_chunked_matches_the_reference_and_the_scan(chunk, with_s0):
    """T 37: not a multiple of any chunk (the last chunk pads w with 1)."""
    args, s0 = _wkv_inputs()
    js0 = jnp.asarray(s0) if with_s0 else None
    ts0 = torch.from_numpy(s0) if with_s0 else None
    jy, js = jax_wkv6_ops.wkv6_chunked(*map(jnp.asarray, args), s0=js0, chunk=chunk)
    y, s = wkv6_ops.wkv6_chunked(*map(torch.from_numpy, args), s0=ts0, chunk=chunk)
    _close(y, jy)
    _close(s, js)
    ys, ss = wkv6_ref.wkv6_scan(*map(torch.from_numpy, args), s0=ts0)
    _close(y, _np(ys), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    _close(s, _np(ss), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_identity_rows_leave_the_state_bit_identical(form):
    """Rows with decay 1 and key 0 (how the model masks padding) leave s0
    exactly as it was, in both forms."""
    args, s0 = _wkv_inputs(t=5)
    r, k, v, w, u = map(torch.from_numpy, args)
    k, w = torch.zeros_like(k), torch.ones_like(w)
    fn = wkv6_ref.wkv6_scan if form == "scan" else wkv6_ops.wkv6_chunked
    _, s = fn(r, k, v, w, u, s0=torch.from_numpy(s0))
    assert torch.equal(s, torch.from_numpy(s0))


def test_wkv6_decode_matches_the_reference():
    rng = np.random.default_rng(1)
    r, k, v = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.7, 0.999, (2, 3, 8)).astype(np.float32)
    u = rng.normal(size=(3, 8)).astype(np.float32)
    s = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    jy, js = jax_wkv6_ref.wkv6_decode_step(*map(jnp.asarray, (r, k, v, w, u, s)))
    y, s_new = wkv6_ref.wkv6_decode_step(*map(torch.from_numpy, (r, k, v, w, u, s)))
    _close(y, jy)
    _close(s_new, js)


@pytest.fixture(scope="module")
def libs():
    return load_library("torch_cpu").ops, jax_load_cpu_xla()


def jax_load_cpu_xla():
    from repro.core import load_library as jax_load_library

    return jax_load_library("cpu_xla").ops


@pytest.mark.parametrize("prim", ["token_shift", "token_shift_prev", "silu", "sigmoid",
                                  "wkv6_scan", "wkv6_scan_s0", "wkv6_decode"])
def test_torch_cpu_primitives_match_cpu_xla(prim, libs):
    port, ref = libs
    rng = np.random.default_rng(3)
    if prim.startswith("token_shift"):
        x = rng.uniform(-2, 2, (2, 5, 6)).astype(np.float32)
        mu = rng.uniform(0, 1, 6).astype(np.float32)
        prev = rng.uniform(-2, 2, (2, 6)).astype(np.float32) if prim.endswith("prev") \
            else None
        want = ref.token_shift(jnp.asarray(x), jnp.asarray(mu),
                               prev=None if prev is None else jnp.asarray(prev))
        got = port.token_shift(torch.from_numpy(x), torch.from_numpy(mu),
                               prev=None if prev is None else torch.from_numpy(prev))
        _close(got, want)
        return
    if prim in ("silu", "sigmoid"):
        x = rng.uniform(-8, 8, (6, 19)).astype(np.float32)
        _close(getattr(port, prim)(torch.from_numpy(x)), getattr(ref, prim)(jnp.asarray(x)))
        return
    if prim == "wkv6_decode":
        (r, k, v, w, u), s0 = _wkv_inputs(t=1)
        args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
        want = ref.wkv6_decode(*map(jnp.asarray, args))
        got = port.wkv6_decode(*map(torch.from_numpy, args))
    else:
        args, s0 = _wkv_inputs(t=11)
        with_s0 = prim.endswith("s0")
        want = ref.wkv6_scan(*map(jnp.asarray, args), s0=jnp.asarray(s0) if with_s0 else None)
        got = port.wkv6_scan(*map(torch.from_numpy, args),
                             s0=torch.from_numpy(s0) if with_s0 else None)
    for g, w_ in zip(got, want):
        _close(g, w_)


def test_selection_chunked_on_h100_the_scan_on_torch_cpu():
    """The reference's TPU target picks wkv6_chunked(chunk=32) through its
    extra flag; the port's h100 does through ``cuda``; torch_cpu keeps the
    time-step scan (the shortest of its three candidates)."""
    def chosen(target):
        lib = load_library(target)
        man = json.loads((Path(lib.__file__).parent / "_manifest.json").read_text())
        src = (Path(lib.__file__).parent / "ops_seq.py").read_text()
        return man["primitives"]["wkv6_scan"], src

    h100, h100_src = chosen("h100")
    cpu, cpu_src = chosen("torch_cpu")
    assert set(h100) == set(cpu) == {"float32"}
    assert h100["float32"]["required_flags"] == ["torch", "cuda"]
    assert h100["float32"]["candidates"] == 4 and cpu["float32"]["candidates"] == 3
    assert "chunk=32" in h100_src and "_wkv6_scan_ref(r, k, v, w, u, s0=s0)" in cpu_src


def test_bf16_call_takes_the_float32_specialization(libs):
    """wkv6_scan is float32-only, as in the reference: a bf16 call goes
    through the dispatch's default slot, y in r's dtype, s float32."""
    port, _ = libs
    args, _ = _wkv_inputs(t=6)
    r, k, v, w, u = (torch.from_numpy(a).to(torch.bfloat16) for a in args)
    y, s = port.wkv6_scan(r, k, v, w, u)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = wkv6_ref.wkv6_scan(r, k, v, w, u)
    assert torch.equal(y, y32) and torch.equal(s, s32)


@pytest.mark.parametrize("term,tp", [("flops", 1), ("bytes", 1), ("comms", 4)])
def test_wkv6_cost_terms_equal_the_references(term, tp):
    import repro.tsl_api as jax_tsl_api

    shapes = dict(B=8, T=64, H=64, K=64, V=64, TP=tp)
    want = jax_tsl_api.cost("wkv6_scan", term, **shapes)
    assert tsl_api.cost("wkv6_scan", term, device="cpu", **shapes) == want


# -- (b) the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_reduced_config_is_the_references():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv_head_dim,
            cfg.rwkv_head_dim) == (2, 64, 4, 16)


def test_forward_logits_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    assert isinstance(model, RwkvModel) and model.lib.TARGET_NAME == "torch_cpu"
    toks = _tokens(model.cfg, 2, 10, 0)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want, MODEL_ATOL, MODEL_RTOL)


def test_the_h100_library_runs_the_chunked_scan_to_the_same_logits(pair):
    """The h100 library on host tensors (its wkv6_scan is the chunked form,
    every other primitive the plain version on the CPU): logits within
    CHUNKED_TOL of the torch_cpu library's, as phase 7a holds them on the
    card."""
    _, _, model, params = pair
    h100 = build_model(model.cfg, device="cpu", target="h100")
    toks = _tokens(model.cfg, 2, 40, 1)
    want = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    got = h100.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, _np(want), CHUNKED_TOL, CHUNKED_TOL)


def test_prefill_and_six_decode_steps_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    toks = _tokens(cfg, 2, 9, 2)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    tl, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    _close(tl, jl, MODEL_ATOL, MODEL_RTOL)
    assert set(st) == set(jst) == {"tm_prev", "cm_prev", "s"}
    for leaf in st:
        assert tuple(st[leaf].shape) == jst[leaf].shape
        _close(st[leaf], jst[leaf], MODEL_ATOL, MODEL_RTOL)
    for i in range(6):
        tok = np.asarray(jl)[:, :cfg.vocab].argmax(-1)[:, None].astype(np.int32)
        assert (tl[:, :cfg.vocab].argmax(-1).numpy() == tok[:, 0]).all()
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok), jnp.int32(9 + i))
        tl, st = model.decode_step(params, st, torch.from_numpy(tok), 9 + i)
        _close(tl, jl, MODEL_ATOL, MODEL_RTOL)
    for leaf in st:
        _close(st[leaf], jst[leaf], MODEL_ATOL, MODEL_RTOL)


def test_load_jax_params_keeps_w_base_float32_in_a_bf16_model():
    jcfg = jax_get_config(ARCH).reduced().replace(dtype="bfloat16")
    cfg = get_config(ARCH).reduced().replace(dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    mix = params["blocks"]["mix"]
    assert mix["w_base"].dtype == torch.float32
    assert mix["wr"].dtype == params["embed"].dtype == torch.bfloat16
    assert params["blocks"]["ln1"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mix["w_base"].numpy(),
                                  np.asarray(jparams["blocks"]["mix"]["w_base"]))
    # the port's own init makes the same dtypes
    own = build_model(cfg, device="cpu").init(0)
    assert own["blocks"]["mix"]["w_base"].dtype == torch.float32
    assert float(own["blocks"]["mix"]["w_base"].min()) == -6.0
    assert own["blocks"]["mix"]["mu_r"].dtype == torch.bfloat16


# -- (c) chunked prefill ----------------------------------------------------------


@pytest.mark.parametrize("target", ["torch_cpu", "h100"])
@pytest.mark.parametrize("chunk,padded_len", [(1, None), (3, None), (4, None), (16, None),
                                              (4, 16)])
def test_prefill_chunk_matches_whole_prompt(pair, chunk, padded_len, target):
    """As tests/test_serve_chunked.py: chunk 1, a ragged tail (prompt 9 in
    chunks of 4: n_real 1), one padded chunk (16), and a bucket of 16 in
    chunks of 4 whose last two chunks are all padding; the last real row's
    logits and a decode step after the chunks equal whole-prompt prefill's.
    ``h100`` runs the chunked scan."""
    _, _, base, params = pair
    model = build_model(base.cfg, device="cpu", target=target)
    cfg, prompt_len = model.cfg, 9
    toks = _tokens(cfg, 1, prompt_len, 0)
    want_logits, want_state = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    nxt = torch.tensor([[int(want_logits[0, :cfg.vocab].argmax())]])
    want_dec, _ = model.decode_step(params, {k: v.clone() for k, v in want_state.items()},
                                    nxt, prompt_len)
    padded_len = padded_len or -(-prompt_len // chunk) * chunk
    padded = np.zeros((1, padded_len), np.int64)
    padded[:, :prompt_len] = toks
    state, fill, last = model.init_decode_state(1, 24), 0, None
    for ci in range(padded_len // chunk):
        n_real = max(0, min(prompt_len - ci * chunk, chunk))
        logits, state = model.prefill_chunk(
            params, state, torch.from_numpy(padded[:, ci * chunk:(ci + 1) * chunk]), fill,
            n_real=torch.tensor([n_real]))
        if n_real:
            last = logits[:, n_real - 1]
            fill += n_real
    assert fill == prompt_len
    _close(last, _np(want_logits), CHUNK_TOL, CHUNK_TOL)
    got_dec, _ = model.decode_step(params, state, nxt, prompt_len)
    _close(got_dec, _np(want_dec), CHUNK_TOL, CHUNK_TOL)


@pytest.mark.parametrize("target", ["torch_cpu", "h100"])
def test_a_slot_with_no_real_row_stays_bit_identical(pair, target):
    """A per-slot n_real of 0 (an idle or rejected slot in a commit, an
    all-padding bucket chunk) leaves that slot's state bit for bit; the
    verify step writes nothing; a commit of n rows equals a prefill chunk of
    the first n tokens."""
    _, _, base, params = pair
    model = build_model(base.cfg, device="cpu", target=target)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    state = model.init_decode_state(3, 24)
    _, donor = model.prefill(params, {"tokens": torch.from_numpy(_tokens(cfg, 3, 7, 5))}, 24)
    for k in state:
        state[k].copy_(donor[k])
    before = {k: v.clone() for k, v in state.items()}
    span = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 5)))
    logits, out = model.verify_step(params, state, span, torch.tensor([7, 7, 7]))
    assert out is state and all(torch.equal(state[k], before[k]) for k in state)
    n_commit = torch.tensor([2, 0, 5])
    model.verify_commit(params, state, span, None, n_commit)
    for k in state:
        assert torch.equal(state[k][:, 1], before[k][:, 1]), k
    for slot, n in ((0, 2), (2, 5)):
        one = {k: v[:, slot:slot + 1].clone() for k, v in before.items()}
        want, one = model.prefill_chunk(params, one, span[slot:slot + 1, :n], 7)
        for k in state:
            _close(state[k][:, slot], _np(one[k][:, 0]), MODEL_ATOL, MODEL_RTOL)
        _close(logits[slot, :n], _np(want[0]), MODEL_ATOL, MODEL_RTOL)


# -- (e) what stays out of this slice ----------------------------------------------


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("arch", ["whisper-tiny", "arctic-480b", "grok-1-314b",
                                  "internvl2-2b"])
def test_other_families_still_raise(arch):
    """The other families build from the reference's own configs: whisper
    and internvl2 build a train step now (tests/test_torch_train_embeds.py
    holds their training against the reference); the moe family still
    raises at its training, citing queue 1 item 15."""
    cfg = _port_cfg(jax_get_config(arch).reduced())
    model = build_model(cfg, device="cpu")
    if cfg.family in ("audio", "vlm"):
        step = make_train_step(model, OptConfig())
        assert step.model is model and step.microbatches == 1
        return
    assert cfg.family == "moe"
    with pytest.raises(NotImplementedError, match="item 15"):
        make_train_step(model, OptConfig())


def test_training_refuses_rwkv(pair):
    _, _, model, params = pair
    with pytest.raises(NotImplementedError, match="item 11"):
        make_train_step(model, OptConfig())
    with pytest.raises(NotImplementedError, match="item 11"):
        model.loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                            "labels": torch.zeros((1, 4), dtype=torch.int64)})


def test_admission_prices_rwkv_as_the_reference():
    """The decode step is the param bytes alone (no attention layer), the
    verify price doubles for the commit replay, and param_count is the
    reference's (7.00 B for rwkv6-7b, short of the tree's 7.53 B)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    ours = CostModelAdmission(cfg, 8, 320, lib=tsl_api.lib("cpu"))
    ref = JaxAdmission(jcfg, 8, 320)
    assert ours.param_bytes == ref.param_bytes == 2 * cfg.param_count()
    assert ours.decode_bytes_per_step() == ref.decode_bytes_per_step() == ours.param_bytes
    assert ours.verify_seconds(2) == pytest.approx(2.0 * ours.param_bytes / ours.hbm_bw)
    assert ours.verify_seconds(2) / ours.step_seconds() == pytest.approx(
        ref.verify_seconds(2) / ref.step_seconds())
    assert ours.prefill_seconds(64) == pytest.approx(
        2.0 * cfg.param_count() * 64 / ours.peak_flops)
    n_tree = sum(int(np.prod(s)) for s in _leaf_shapes(cfg))
    assert round(cfg.param_count() / 1e9, 2) == 7.00 and round(n_tree / 1e9, 2) == 7.53


def _leaf_shapes(cfg):
    from repro_torch.nn.rwkv_lm import rwkv_params

    tree = rwkv_params(cfg, lambda kind, shape, **kw: shape)
    out = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else out.append(v)
    walk(tree)
    return out
