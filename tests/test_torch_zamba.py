"""The port's zamba family (zamba2: a Mamba2 backbone with one shared
attention block) against the JAX reference's, on the same numpy inputs: the
four primitives it adds to the corpus, the Mamba2 block, the model on the
reference's params (with and without a remainder stack), chunked prefill,
the verify step and its commit, the fused paged steps, and the plain
versions of the two kernels its attention reaches at head dim 112.

Tolerances (float32 throughout, TF32 irrelevant on the host):

- primitives: 1e-5 absolute + 1e-5 relative against ``repro.kernels.ssd``
  and ``load_library("cpu_xla")`` (summation orders differ); the chunked
  form against the time-step scan 2e-5 (its log-space decay products round
  once more);
- the Mamba2 block and the reduced model (4 layers in 2 groups of 2, or 5
  layers in 2 groups of 2 plus a remainder of 1; d 64, 16 SSD heads of 8,
  N 16, 4 attention heads of 16): outputs and state leaves within 5e-5
  absolute + 1e-5 relative of the reference's (the SSD state sums T outer
  products in another order), greedy tokens identical; chunked prefill
  against whole-prompt prefill within the reference test's 2e-4; the h100
  library's logits (the chunked scan in every layer, 70 tokens) within 1e-4
  of the torch_cpu library's;
- the paged steps' logits 1e-4 + 1e-4 and pools 2e-5 + 1e-5, as
  ``tests/test_torch_paged.py`` holds the dense family's;
- attention at D 112: 1e-5 + 1e-5;
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
from repro.kernels.flash_attention import ref as jax_flash_ref
from repro.kernels.paged import ref as jax_paged_ref
from repro.kernels.ssd import ops as jax_ssd_ops
from repro.kernels.ssd import ref as jax_ssd_ref
from repro.nn import mamba2 as jax_mamba2
from repro.nn.model import build_model as jax_build_model
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.core import load_library
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged import kernel as paged_kernel
from repro_torch.kernels.paged import ops as paged_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.nn import mamba2
from repro_torch.nn.model import ZambaModel, build_model, load_jax_params
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_train_step

ARCH = "zamba2-7b"
ATOL = RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 5e-5, 1e-5
CHUNKED_TOL = 2e-5
CHUNKED_MODEL_TOL = 1e-4          # the h100 library's model (chunked scan) vs torch_cpu's
CHUNK_TOL = 2e-4                  # the reference's own chunked-prefill bar
LOGITS_TOL = 1e-4                 # the paged steps' logits
REST = {"n_layers": 5, "attn_every": 2}     # 2 groups of 2 plus a remainder of 1


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _ssd_inputs(t=37, b=2, h=3, p=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    a = rng.uniform(0.8, 0.999, (b, t, h)).astype(np.float32)
    bb, c = (rng.normal(size=(b, t, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, a, bb, c), h0


# -- (a) the primitives ---------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_the_reference_scan(with_h0):
    args, h0 = _ssd_inputs()
    jy, jh = jax_ssd_ref.ssd_scan(*map(jnp.asarray, args),
                                  h0=jnp.asarray(h0) if with_h0 else None)
    y, h = ssd_ref.ssd_scan(*map(torch.from_numpy, args),
                            h0=torch.from_numpy(h0) if with_h0 else None)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_the_reference_and_the_scan(chunk, with_h0):
    """T 37: not a multiple of any chunk (the last chunk pads a with 1)."""
    args, h0 = _ssd_inputs()
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    jy, jh = jax_ssd_ops.ssd_chunked(*map(jnp.asarray, args), h0=jh0, chunk=chunk)
    y, h = ssd_ops.ssd_chunked(*map(torch.from_numpy, args), h0=th0, chunk=chunk)
    _close(y, jy)
    _close(h, jh)
    ys, hs = ssd_ref.ssd_scan(*map(torch.from_numpy, args), h0=th0)
    _close(y, _np(ys), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    _close(h, _np(hs), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_identity_rows_leave_the_state_bit_identical(form):
    """Rows with decay 1 and input 0 (how the model masks padding) leave h0
    exactly as it was, in both forms."""
    args, h0 = _ssd_inputs(t=5)
    x, a, b, c = map(torch.from_numpy, args)
    fn = ssd_ref.ssd_scan if form == "scan" else ssd_ops.ssd_chunked
    _, h = fn(torch.zeros_like(x), torch.ones_like(a), b, c, h0=torch.from_numpy(h0))
    assert torch.equal(h, torch.from_numpy(h0))


def test_ssd_decode_matches_the_reference():
    (x, a, b, c), h0 = _ssd_inputs(t=1, seed=1)
    args = (x[:, 0], a[:, 0], b[:, 0], c[:, 0], h0)
    jy, jh = jax_ssd_ref.ssd_decode_step(*map(jnp.asarray, args))
    y, h = ssd_ref.ssd_decode_step(*map(torch.from_numpy, args))
    _close(y, jy)
    _close(h, jh)


@pytest.fixture(scope="module")
def libs():
    from repro.core import load_library as jax_load_library

    return load_library("torch_cpu").ops, jax_load_library("cpu_xla").ops


@pytest.mark.parametrize("prim", ["causal_conv1d", "ssd_scan", "ssd_scan_h0", "ssd_chunked",
                                  "ssd_decode"])
def test_torch_cpu_primitives_match_cpu_xla(prim, libs):
    port, ref = libs
    rng = np.random.default_rng(3)
    if prim == "causal_conv1d":
        x = rng.uniform(-2, 2, (2, 9, 6)).astype(np.float32)
        w = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
        _close(port.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w)),
               ref.causal_conv1d(jnp.asarray(x), jnp.asarray(w)))
        return
    if prim == "ssd_decode":
        (x, a, b, c), h0 = _ssd_inputs(t=1)
        args = (x[:, 0], a[:, 0], b[:, 0], c[:, 0], h0)
        want = ref.ssd_decode(*map(jnp.asarray, args))
        got = port.ssd_decode(*map(torch.from_numpy, args))
    else:
        args, h0 = _ssd_inputs(t=11)
        with_h0 = prim.endswith("h0")
        kw = {"chunk": 4} if prim == "ssd_chunked" else {}
        fn = "ssd_chunked" if prim == "ssd_chunked" else "ssd_scan"
        want = getattr(ref, fn)(*map(jnp.asarray, args),
                                h0=jnp.asarray(h0) if with_h0 else None, **kw)
        got = getattr(port, fn)(*map(torch.from_numpy, args),
                                h0=torch.from_numpy(h0) if with_h0 else None, **kw)
    for g, w_ in zip(got, want):
        _close(g, w_)


def test_causal_conv1d_keeps_bf16(libs):
    """float32 inside, the input's dtype out, as the reference."""
    port, _ = libs
    x = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, (1, 5, 3)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.ones((3, 3), dtype=torch.bfloat16)
    y = port.causal_conv1d(x, w)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, (x.float() + torch.nn.functional.pad(x.float(), (0, 0, 1, 0))
                                   [:, :-1] + torch.nn.functional.pad(x.float(), (0, 0, 2, 0))
                                   [:, :-2]).to(torch.bfloat16))


def test_selection_chunked_at_64_on_h100_the_scan_on_torch_cpu():
    """The reference's TPU targets pick ssd_chunked(chunk=64) through their
    extra flag; the port's h100 does through ``cuda``; torch_cpu keeps the
    time-step scan (the shortest of its three candidates)."""
    def chosen(target):
        lib = load_library(target)
        man = json.loads((Path(lib.__file__).parent / "_manifest.json").read_text())
        src = (Path(lib.__file__).parent / "ops_seq.py").read_text()
        return man["primitives"]["ssd_scan"], src

    h100, h100_src = chosen("h100")
    cpu, cpu_src = chosen("torch_cpu")
    assert set(h100) == set(cpu) == {"float32"}
    assert h100["float32"]["required_flags"] == ["torch", "cuda"]
    assert h100["float32"]["candidates"] == 4 and cpu["float32"]["candidates"] == 3
    assert "_ssd_chunked(x, a, b, c, h0=h0, chunk=64)" in h100_src
    assert "_ssd_scan_ref(x, a, b, c, h0=h0)" in cpu_src


@pytest.mark.parametrize("term,tp", [("flops", 1), ("bytes", 1), ("comms", 4)])
def test_ssd_cost_terms_equal_the_references(term, tp):
    import repro.tsl_api as jax_tsl_api

    shapes = dict(B=8, T=64, H=112, P=64, N=64, TP=tp)
    want = jax_tsl_api.cost("ssd_scan", term, **shapes)
    assert tsl_api.cost("ssd_scan", term, device="cpu", **shapes) == want


# -- (b) the Mamba2 block ----------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """Reduced zamba's Mamba2 block on the reference's init, with A_log,
    dt_bias and D_skip drawn at random (their init is constant)."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_mamba2.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    nh = jp["A_log"].shape[0]
    jp = {**jp, "A_log": jnp.asarray(rng.uniform(-1, 1, nh), jnp.float32),
          "dt_bias": jnp.asarray(rng.uniform(-1, 1, nh), jnp.float32),
          "D_skip": jnp.asarray(rng.uniform(0, 2, nh), jnp.float32)}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        mamba2.mamba2_params(cfg, lambda kind, shape, **kw: tuple(shape))
    return jcfg, cfg, jp, p, load_library("torch_cpu").ops


@pytest.mark.parametrize("n_real", [None, 4, "per_slot"])
def test_mamba2_forward_matches_the_reference(block, n_real):
    """From a carried h0 and conv window; ``n_real`` scalar or per slot (one
    slot all padding): y's real rows, h_final and the conv tail."""
    jcfg, cfg, jp, p, tsl = block
    d_in, nh, n, pd = mamba2.dims(cfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 7, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(3, nh, pd, n)).astype(np.float32)
    conv = rng.normal(size=(3, cfg.conv_width - 1, d_in)).astype(np.float32)
    nr = np.asarray([7, 2, 0]) if n_real == "per_slot" else n_real
    jy, (jh, jc) = jax_mamba2.mamba2_forward(
        jp, jnp.asarray(x), jcfg, h0=jnp.asarray(h0), conv_prev=jnp.asarray(conv),
        n_real=None if nr is None else jnp.asarray(nr))
    y, (h, c) = mamba2.mamba2_forward(
        tsl, p, torch.from_numpy(x), cfg, h0=torch.from_numpy(h0),
        conv_prev=torch.from_numpy(conv), n_real=None if nr is None else torch.as_tensor(nr))
    rows = 7 if nr is None else (nr if np.ndim(nr) == 0 else None)
    if rows is None:
        for s, r in enumerate(nr):
            _close(y[s, :r], np.asarray(jy)[s, :r], MODEL_ATOL, MODEL_RTOL)
    else:
        _close(y[:, :rows], np.asarray(jy)[:, :rows], MODEL_ATOL, MODEL_RTOL)
    _close(h, jh, MODEL_ATOL, MODEL_RTOL)
    _close(c, jc, MODEL_ATOL, MODEL_RTOL)
    if n_real == "per_slot":         # an all-padding sequence keeps its carries exactly
        assert torch.equal(h[2], torch.from_numpy(h0[2]))
        assert torch.equal(c[2], torch.from_numpy(conv[2]))


def test_mamba2_decode_matches_the_reference(block):
    jcfg, cfg, jp, p, tsl = block
    d_in, nh, n, pd = mamba2.dims(cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(2, nh, pd, n)).astype(np.float32)
    conv = rng.normal(size=(2, cfg.conv_width - 1, d_in)).astype(np.float32)
    jy, jh, jc = jax_mamba2.mamba2_decode(jp, *map(jnp.asarray, (x,)), jcfg,
                                          jnp.asarray(h), jnp.asarray(conv))
    y, h_new, c = mamba2.mamba2_decode(tsl, p, torch.from_numpy(x), cfg, torch.from_numpy(h),
                                       torch.from_numpy(conv))
    _close(y, jy, MODEL_ATOL, MODEL_RTOL)
    _close(h_new, jh, MODEL_ATOL, MODEL_RTOL)
    _close(c, jc)


# -- (c) the model ---------------------------------------------------------------


def _pair(**change):
    jcfg = jax_get_config(ARCH).reduced().replace(**change)
    cfg = get_config(ARCH).reduced().replace(**change)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module", params=["groups", "rest"])
def pair(request):
    """The reduced config (2 groups of 2, no remainder) and a variant with a
    remainder stack (5 layers, attn_every 2: the full config has 3)."""
    return _pair(**({} if request.param == "groups" else REST))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_reduced_config_is_the_references():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    cfg = get_config(ARCH)
    d_in, nh, n, pd = mamba2.dims(cfg)
    from repro_torch.nn.zamba import layout

    assert layout(cfg) == (13, 6, 3) and (cfg.hd, d_in, nh, n, pd) == (112, 7168, 112, 64, 64)
    red = cfg.reduced()
    assert layout(red) == (2, 2, 0) and (red.d_model, red.hd) == (64, 16)


def test_forward_logits_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    assert isinstance(model, ZambaModel) and model.lib.TARGET_NAME == "torch_cpu"
    assert ("rest" in params) == (model.cfg.n_layers == 5)
    toks = _tokens(model.cfg, 2, 10, 0)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want, MODEL_ATOL, MODEL_RTOL)


def test_the_h100_library_runs_the_chunked_scan_to_the_same_logits(pair):
    """The h100 library on host tensors (its ssd_scan is the chunked form,
    every other primitive the plain version on the CPU): logits within
    CHUNKED_MODEL_TOL of the torch_cpu library's."""
    _, _, model, params = pair
    h100 = build_model(model.cfg, device="cpu", target="h100")
    toks = _tokens(model.cfg, 2, 70, 1)
    want = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    got = h100.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, _np(want), CHUNKED_MODEL_TOL, CHUNKED_MODEL_TOL)


def test_prefill_and_six_decode_steps_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    toks = _tokens(cfg, 2, 9, 2)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    tl, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    _close(tl, jl, MODEL_ATOL, MODEL_RTOL)
    assert set(st) == set(jst)
    for leaf in st:
        assert tuple(st[leaf].shape) == jst[leaf].shape and st[leaf].dtype == \
            (torch.float32 if leaf.startswith("h") else model.dtype)
        _close(st[leaf], jst[leaf], MODEL_ATOL, MODEL_RTOL)
    for i in range(6):
        tok = np.asarray(jl)[:, :cfg.vocab].argmax(-1)[:, None].astype(np.int32)
        assert (tl[:, :cfg.vocab].argmax(-1).numpy() == tok[:, 0]).all()
        pos = np.asarray([9 + i, 9 + i])
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok), jnp.asarray(pos))
        tl, st = model.decode_step(params, st, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl, MODEL_ATOL, MODEL_RTOL)
    for leaf in st:
        _close(st[leaf], jst[leaf], MODEL_ATOL, MODEL_RTOL)


def test_state_axes_are_the_references(pair):
    jmodel, _, model, _ = pair
    state = model.init_decode_state(2, 8)
    jstate = jmodel.init_decode_state(2, 8)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}
    assert model.state_batch_axes(state) == jmodel.state_batch_axes(jstate)
    assert model.state_page_axes(state) == jmodel.state_page_axes(jstate)


def test_load_jax_params_keeps_the_float32_leaves_in_a_bf16_model():
    jcfg = jax_get_config(ARCH).reduced().replace(dtype="bfloat16", **REST)
    cfg = get_config(ARCH).reduced().replace(dtype="bfloat16", **REST)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for stack in ("groups", "rest"):
        mamba = params[stack]["mamba"]
        for leaf in ("A_log", "dt_bias", "D_skip"):
            assert mamba[leaf].dtype == torch.float32, (stack, leaf)
            np.testing.assert_array_equal(mamba[leaf].numpy(),
                                          np.asarray(jparams[stack]["mamba"][leaf]))
        assert mamba["in_proj"].dtype == mamba["gate_norm_w"].dtype == torch.bfloat16
    assert params["shared_attn"]["wq"].dtype == params["embed"].dtype == torch.bfloat16
    assert params["groups"]["mamba"]["in_proj"].shape[:2] == (2, 2)
    # the port's own init makes the same dtypes
    own = build_model(cfg, device="cpu").init(0)
    assert own["rest"]["mamba"]["D_skip"].dtype == torch.float32
    assert float(own["groups"]["mamba"]["D_skip"].min()) == 1.0
    assert own["groups"]["mamba"]["conv_w"].dtype == torch.bfloat16


# -- (d) chunked prefill, the verify step and the commit ---------------------------


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
            params, state, torch.from_numpy(padded[:, ci * chunk:(ci + 1) * chunk]),
            torch.tensor([fill]), n_real=torch.tensor([n_real]))
        if n_real:
            last = logits[:, n_real - 1]
            fill += n_real
    assert fill == prompt_len
    _close(last, _np(want_logits), CHUNK_TOL, CHUNK_TOL)
    got_dec, _ = model.decode_step(params, state, nxt, prompt_len)
    _close(got_dec, _np(want_dec), CHUNK_TOL, CHUNK_TOL)


TAILS = ("h", "conv", "h_rest", "conv_rest")


@pytest.mark.parametrize("target", ["torch_cpu", "h100"])
def test_a_slot_with_no_real_row_stays_bit_identical(pair, target):
    """A per-slot n_real of 0 (an idle or rejected slot in a commit) leaves
    that slot's tails and cache rows before the span bit for bit; the
    verify step writes no tail; a commit of n rows equals a prefill chunk
    of the first n tokens."""
    _, _, base, params = pair
    model = build_model(base.cfg, device="cpu", target=target)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    _, state = model.prefill(params, {"tokens": torch.from_numpy(_tokens(cfg, 3, 7, 5))}, 24)
    before = {k: v.clone() for k, v in state.items()}
    axes = model.state_batch_axes(state)
    span = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 5)))
    pos = torch.tensor([7, 7, 7])
    logits, out = model.verify_step(params, state, span, pos)
    assert out is state
    for k in state:
        if k in TAILS:
            assert torch.equal(state[k], before[k]), k
        else:       # the span's rows only
            assert torch.equal(state[k][:, :, :, :7], before[k][:, :, :, :7]), k
    n_commit = torch.tensor([2, 0, 5])
    model.verify_commit(params, state, span, pos, n_commit)
    for k in state:
        if k in TAILS:
            assert torch.equal(state[k].select(axes[k], 1), before[k].select(axes[k], 1)), k
    for slot, n in ((0, 2), (2, 5)):
        one = {k: v.narrow(axes[k], slot, 1).clone() for k, v in before.items()}
        want, one = model.prefill_chunk(params, one, span[slot:slot + 1, :n], 7)
        for k in state:
            got = state[k].select(axes[k], slot)
            if k not in TAILS:
                got, ref = got[:, :, :7 + n], one[k].select(axes[k], 0)[:, :, :7 + n]
            else:
                ref = one[k].select(axes[k], 0)
            _close(got, _np(ref), MODEL_ATOL, MODEL_RTOL)
        _close(logits[slot, :n], _np(want[0]), MODEL_ATOL, MODEL_RTOL)


def test_verify_and_commit_match_the_reference(pair):
    """The verify span's logits against zamba_verify_step, and the commit's
    replay (per-slot n_commit, one slot 0) against the reference's
    verify_commit: every tail leaf, and every cache row up to each slot's
    committed fill."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(8)
    toks = _tokens(cfg, 3, 6, 9)
    _, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    _, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    span = rng.integers(0, cfg.vocab, (3, 4)).astype(np.int32)
    pos = np.asarray([6, 6, 6])
    jl, jst = jmodel.verify_step(jparams, jst, jnp.asarray(span), jnp.asarray(pos))
    tl, st = model.verify_step(params, st, torch.from_numpy(span), torch.from_numpy(pos))
    _close(tl, jl, MODEL_ATOL, MODEL_RTOL)
    n_commit = np.asarray([3, 0, 4])
    jst = jmodel.verify_commit(jparams, jst, jnp.asarray(span), jnp.asarray(pos),
                               jnp.asarray(n_commit))
    st = model.verify_commit(params, st, torch.from_numpy(span), torch.from_numpy(pos),
                             torch.from_numpy(n_commit))
    for k in TAILS:
        if k in st:
            _close(st[k], jst[k], MODEL_ATOL, MODEL_RTOL)
    for slot, n in enumerate(n_commit):
        for k in ("attn_k", "attn_v"):
            _close(st[k][:, slot, :, :6 + n], np.asarray(jst[k])[:, slot, :, :6 + n],
                   MODEL_ATOL, MODEL_RTOL)


# -- (e) the fused paged steps -------------------------------------------------------


def _paged_setup(jmodel, jparams, cfg, fills, span, page=4, max_len=24, seed=11):
    """Slots prefilled one by one (fill 0: idle, all-scratch table row), their
    shared-attention K/V rows scattered into fused pools (G, 1, KH,
    n_pages, page, hd) through permuted tables (page 0 the scratch page),
    their tails stacked into a tails-only state. Returns (tails, pools,
    tables) as numpy."""
    rng = np.random.default_rng(seed)
    width = max_len // page
    need = [-(-(n + span) // page) if n else 0 for n in fills]
    n_pages = 1 + sum(need) + 2
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((len(fills), width), np.int32)
    for i, u in enumerate(need):
        tables[i, :u] = perm[:u]
        perm = perm[u:]
    state = jmodel.init_decode_state(len(fills), max_len)
    tails = {k: np.array(v) for k, v in state.items() if not k.startswith("attn")}
    g = tails["h"].shape[0]
    pools = {n: np.zeros((g, 1, cfg.n_kv_heads, n_pages, page, cfg.hd), np.float32)
             for n in ("attn_k", "attn_v")}
    for i, n in enumerate(fills):
        if not n:
            continue
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        _, st = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
        for k in tails:
            ax = 2 if k in ("h", "conv") else 1
            idx = [slice(None)] * tails[k].ndim
            idx[ax] = i
            tails[k][tuple(idx)] = np.take(np.asarray(st[k]), 0, axis=ax)
        for leaf in pools:
            rows = np.asarray(st[leaf])[:, 0, :, :n]                # (G, KH, n, hd)
            for r in range(n):
                pools[leaf][:, 0, :, tables[i, r // page], r % page] = rows[:, :, r]
    return tails, pools, tables


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["decode", "verify", "commit"])
def test_paged_steps_match_the_reference(pair, kind):
    """One fused paged decode step, verify span of 4, and commit replay
    (n_commit 3, 4 and 0: the idle slot) at per-slot positions through both
    models: logits, the tails and the pools."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    fills = [13, 6, 0]
    span = 1 if kind == "decode" else 4
    tails, pools, tables = _paged_setup(jmodel, jparams, cfg, fills, span)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab, (3, span)).astype(np.int32)
    pos = np.asarray(fills, np.int32)
    jargs = (jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(pos))
    targs = (torch.from_numpy(tables), torch.from_numpy(tokens), torch.from_numpy(pos))
    got_tails, got_pools = _torch_tree(tails), _torch_tree(pools)
    if kind == "commit":
        n_commit = np.asarray([3, 4, 0])
        want_tails, want_pools = jmodel.verify_commit_paged(
            jparams, _jax_tree(tails), _jax_tree(pools), *jargs, jnp.asarray(n_commit))
        out_tails, out_pools = model.verify_commit_paged(
            params, got_tails, got_pools, *targs, torch.from_numpy(n_commit))
    else:
        jfn = jmodel.decode_step_paged if kind == "decode" else jmodel.verify_step_paged
        fn = model.decode_step_paged if kind == "decode" else model.verify_step_paged
        want_logits, want_tails, want_pools = jfn(jparams, _jax_tree(tails), _jax_tree(pools),
                                                  *jargs)
        got_logits, out_tails, out_pools = fn(params, got_tails, got_pools, *targs)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert out_tails is got_tails and out_pools is got_pools      # written in place
    for k in tails:
        _close(got_tails[k], want_tails[k], MODEL_ATOL, MODEL_RTOL)
        if kind == "verify":
            assert torch.equal(got_tails[k], torch.from_numpy(tails[k])), k
    for leaf in pools:
        _close(got_pools[leaf], want_pools[leaf], 2e-5, 1e-5)
    if kind == "commit":            # the idle slot's tails exactly as they were
        assert torch.equal(got_tails["h"][:, :, 2], torch.from_numpy(tails["h"][:, :, 2]))


# -- (f) the kernels' plain versions at head dim 112 --------------------------------


@pytest.mark.parametrize("sq,sk,causal,kv_len", [(64, 64, True, None), (5, 40, True, 33),
                                                 (7, 19, False, None)])
def test_flash_attention_plain_version_at_d112_matches_the_reference(sq, sk, causal, kv_len):
    rng = np.random.default_rng(13)
    q = rng.normal(size=(2, 4, sq, 112)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, sk, 112)).astype(np.float32) for _ in range(2))
    want = jax_flash_ref.attention(*map(jnp.asarray, (q, k, v)), causal=causal, kv_len=kv_len)
    got = flash_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                    kv_len=kv_len)
    _close(got, want)


@pytest.mark.parametrize("sq", [1, 5])
def test_paged_plain_version_at_d112_matches_the_oracle(sq):
    rng = np.random.default_rng(14)
    page, width, kv_lens = 16, 4, [5 + sq, 33, 64]
    n_pages = 1 + width * 3
    q = rng.normal(size=(3, 8, sq, 112)).astype(np.float32)
    k, v = (rng.normal(size=(8, n_pages, page, 112)).astype(np.float32) for _ in range(2))
    tables = (1 + rng.permutation(n_pages - 1)[:3 * width]).reshape(3, width).astype(np.int32)
    kv_len = np.asarray(kv_lens, np.int32)
    want = jax_paged_ref.paged_attention_ref(*map(jnp.asarray, (q, k, v, tables, kv_len)))
    got = paged_ops.paged_attention(*map(torch.from_numpy, (q, k, v, tables, kv_len)))
    _close(got, want)


def test_the_kernels_take_d112():
    """Both CUDA kernels are built at D 112, flash for serving and training:
    every C entry point (the forward with and without the lse, dq, dk/dv)
    dispatches D 112 in both dtypes; the paged float32 path's tile is a
    power of two that divides the serving page."""
    assert 112 in flash_kernel.HEAD_DIMS and 112 in paged_kernel.HEAD_DIMS
    rows = {d: paged_kernel.tile_rows(torch.float32, d) for d in (64, 112, 128)}
    assert rows == {64: 64, 112: 32, 128: 32}
    assert paged_kernel.tile_rows(torch.bfloat16, 112) == 64
    src = Path(paged_kernel.SOURCES[0]).read_text()
    assert "launch_mma_rows<112>" in src and "launch_f32<112>" in src
    fwd = Path(flash_kernel.SOURCES[0]).read_text()
    assert "D == 112 ? pick<112>(dtype, lse != nullptr)" in fwd and "pick_serving" not in fwd
    bwd = Path(flash_kernel.BWD_SOURCES[0]).read_text()
    for call in ("TSL_DQ(float, 112)", "TSL_DKV(float, 112)", "launch_dq_mma<112>(",
                 "launch_dkv_mma<112>("):
        assert bwd.count(call) == 1, call


# -- (g) what stays out of this slice ------------------------------------------------


@pytest.mark.parametrize("change", [{"attn_every": 0}, {"ssm_state": 0}])
def test_a_hybrid_config_without_its_layout_is_refused(change):
    cfg = get_config(ARCH).reduced().replace(**change)
    with pytest.raises(NotImplementedError, match="hybrid config"):
        build_model(cfg, device="cpu")


def test_training_refuses_zamba():
    """Training zamba is ported: make_train_step builds its step and the
    loss is finite (tests/test_torch_train_zamba.py holds it against the
    reference); the families still not trained, rwkv and moe, refuse by
    their ROADMAP items."""
    _, _, model, params = _pair()
    assert make_train_step(model, OptConfig()).model is model
    loss, metrics = model.loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                                        "labels": torch.zeros((1, 4), dtype=torch.int64)})
    assert torch.isfinite(loss) and metrics["aux"].item() == 0.0
    for arch, item in (("rwkv6-7b", "item 11"), ("grok-1-314b", "item 15")):
        other = build_model(get_config(arch).reduced(), device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(other, OptConfig())
