"""The port's audio family (whisper: an encoder over precomputed frame
embeddings, a decoder with causal self-attention and cross-attention)
against the JAX reference's ``repro/nn/encdec.py``, on the same numpy
inputs, with the reference's params carried across by ``load_jax_params``:
``gelu`` and the GELU MLP, ``encode``, the teacher-forced logits, prefill,
chunked prefill (the first chunk with frames, a later one without), decode
steps, the verify span, and the fused paged decode and verify steps on
full-precision and int8 pools.

Reduced whisper-tiny (the reference's ``reduced()``: 2 encoder + 2 decoder
layers, d 64, 4 heads of 16, d_ff 128, vocab 256, float32), 12 frames.

Tolerances (float32 throughout, TF32 irrelevant on the host):

- ``gelu``: float32 within 1e-6 absolute + 1e-6 relative of
  ``jax.nn.gelu`` (tanh form; the two libraries' tanh round apart, and
  1 + tanh cancels near x = -6, where gelu is ~1e-5), bf16 within one bf16
  step (2^-8 relative) + the same 1e-6 — a float32 difference can move a
  bf16 rounding;
- the model's outputs and state leaves: 1e-5 absolute + 1e-5 relative of
  the reference's (the two sum the same products in other orders), greedy
  tokens identical; chunked prefill against whole-prompt prefill within the
  reference test's 2e-4 (``tests/test_serve_chunked.py``);
- the paged steps on full-precision pools: logits 1e-5 + 1e-5, pools
  1e-5 + 1e-5; on int8 pools (``tests/test_torch_serve_int8.py``'s bar):
  logits 1e-3 + 1e-3, payloads equal but for <= 1 % off by one, scales
  within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import encdec as jax_encdec
from repro.nn import mlp as jax_mlp
from repro.nn.model import build_model as jax_build_model
from repro.tsl_api import ops as jax_ops
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.nn import encdec
from repro_torch.nn.lm import unstack_layers
from repro_torch.nn.mlp import mlp_forward
from repro_torch.nn.model import EncDecModel, build_model, load_jax_params
from repro_torch.train import OptConfig, init_opt_state, make_train_step

ARCH = "whisper-tiny"
ATOL = RTOL = 1e-5
CHUNK_TOL = 2e-4                  # the reference's own chunked-prefill bar
INT8_TOL = 1e-3
ENC_LEN = 12


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params


def _inputs(cfg, b=2, s=10, enc_len=ENC_LEN, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.normal(size=(b, enc_len, cfg.d_model)).astype(np.float32)
    return toks, frames


# -- (a) gelu and the GELU MLP ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax_nn_gelu(dtype):
    """The tanh form (jax.nn.gelu's default), float32 internals, on both of
    the port's libraries against ``jax.nn.gelu`` and the ``cpu_xla``
    library's definition."""
    x = np.random.default_rng(1).uniform(-6, 6, (7, 33)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax.nn.gelu(jnp.asarray(x, jdt).astype(jnp.float32)).astype(jdt)
    np.testing.assert_array_equal(np.asarray(jax_ops.gelu(jnp.asarray(x, jdt)), np.float32),
                                  np.asarray(want, np.float32))
    tol = (2.0 ** -8, 1e-6) if dtype == "bfloat16" else (1e-6, 1e-6)
    for target in ("torch_cpu", "h100"):
        got = tsl_api.lib("cpu", target=target).ops.gelu(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol[0],
                                   atol=tol[1])


def test_gelu_mlp_matches_the_reference(pair):
    """``mlp_forward``'s GELU branch (w_in, w_out) on the first decoder
    layer's weights."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    x = np.random.default_rng(2).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"]["mlp"])
    want = jax_mlp.mlp_forward(jp, jnp.asarray(x), jmodel.cfg)
    p = unstack_layers(params["dec_blocks"], cfg.n_layers)[0]["mlp"]
    assert set(p) == {"w_in", "w_out"}
    _close(mlp_forward(model.tsl, p, torch.from_numpy(x), cfg), want)


# -- (b) the encoder, the logits, prefill ------------------------------------------------


def test_encode_matches_the_reference(pair):
    jmodel, jparams, model, params = pair
    _, frames = _inputs(model.cfg)
    want = jax_encdec.encode(jparams, jnp.asarray(frames), jmodel.cfg, remat=False)
    _close(encdec.encode(model.tsl, params, torch.from_numpy(frames), model.cfg), want)


def test_forward_logits_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    assert isinstance(model, EncDecModel)
    toks, frames = _inputs(model.cfg)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks),
                                           "audio_embeds": jnp.asarray(frames)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks),
                                        "audio_embeds": torch.from_numpy(frames)})
    _close(got, want)
    assert np.array_equal(_np(got).argmax(-1), np.asarray(want).argmax(-1))


def test_prefill_matches_the_reference(pair):
    """Last logits and every state leaf: the self-attention caches (padded
    to max_len) and the cross K/V at enc_len rows."""
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                       "audio_embeds": jnp.asarray(frames)}, 16)
    tl, st = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                    "audio_embeds": torch.from_numpy(frames)}, 16)
    _close(tl, jl)
    assert set(st) == set(jst) == {"k", "v", "cross_k", "cross_v"}
    assert st["cross_k"].shape == (2, 2, 4, ENC_LEN, 16) and st["k"].shape[3] == 16
    for k in st:
        _close(st[k], jst[k])


# -- (c) chunked prefill, decode steps, the verify span ----------------------------------


def test_prefill_chunks_match_the_reference_and_whole_prompt(pair):
    """The first chunk (4 tokens) carries the frames and runs the encoder,
    seeding the cross K/V; the second (4 tokens at pos 4) reads them. Each
    chunk's logits and the state against the reference's
    ``encdec_prefill_chunk``; the last row against whole-prompt prefill."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    toks, frames = _inputs(cfg, b=1, s=8)
    jst = jmodel.init_decode_state(1, 16, enc_len=ENC_LEN)
    st = model.init_decode_state(1, 16, enc_len=ENC_LEN)
    assert st["cross_k"].shape[3] == ENC_LEN
    for c0, emb in ((0, frames), (4, None)):
        seg = toks[:, c0:c0 + 4]
        jl, jst = jax_encdec.encdec_prefill_chunk(
            jparams, jst, jnp.asarray(seg), c0, jmodel.cfg,
            audio_embeds=None if emb is None else jnp.asarray(emb))
        tl, out = model.prefill_chunk(params, st, torch.from_numpy(seg), c0,
                                      embeds=None if emb is None else torch.from_numpy(emb))
        assert out is st                                        # written in place
        _close(tl, jl)
        for k in st:
            _close(st[k], jst[k])
    whole, _ = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                      "audio_embeds": torch.from_numpy(frames)}, 16)
    np.testing.assert_allclose(_np(tl)[:, -1], _np(whole), atol=CHUNK_TOL, rtol=CHUNK_TOL)


def _prefilled(jmodel, jparams, model, params, fills, max_len=24, seed=3):
    """A batch of slots prefilled one by one at their own fills (the frames
    each slot's own), stacked: (reference state, port state)."""
    cfg = model.cfg
    jst = jmodel.init_decode_state(len(fills), max_len, enc_len=ENC_LEN)
    st = model.init_decode_state(len(fills), max_len, enc_len=ENC_LEN)
    for i, n in enumerate(fills):
        toks, frames = _inputs(cfg, b=1, s=n, seed=seed + i)
        _, one = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                          "audio_embeds": jnp.asarray(frames)}, max_len)
        jst = jmodel.insert_slot(jst, one, i)
        model.insert_slot(st, {k: _t(v) for k, v in one.items()}, i)
    return jst, st


def test_decode_steps_match_the_reference(pair):
    """Three greedy decode steps at per-slot positions (fills 9 and 5):
    logits, greedy tokens and the state after each."""
    jmodel, jparams, model, params = pair
    fills = [9, 5]
    jst, st = _prefilled(jmodel, jparams, model, params, fills)
    tok = np.asarray([[7], [11]], np.int32)
    for step in range(3):
        pos = np.asarray(fills, np.int32) + step
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok), jnp.asarray(pos))
        tl, st = model.decode_step(params, st, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl)
        for k in st:
            _close(st[k], jst[k])
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(_np(tl).argmax(-1)[:, None], tok)


def test_verify_span_matches_the_reference(pair):
    """A verify span of 4 rows at per-slot bases: the logits of every row
    and the span's rows written into the self-attention caches; the cross
    K/V untouched."""
    jmodel, jparams, model, params = pair
    fills = [9, 5]
    jst, st = _prefilled(jmodel, jparams, model, params, fills)
    cross = {k: st[k].clone() for k in ("cross_k", "cross_v")}
    tokens = np.random.default_rng(5).integers(0, model.cfg.vocab, (2, 4)).astype(np.int32)
    pos = np.asarray(fills, np.int32)
    jl, jst = jmodel.verify_step(jparams, jst, jnp.asarray(tokens), jnp.asarray(pos))
    tl, st = model.verify_step(params, st, torch.from_numpy(tokens), torch.from_numpy(pos))
    _close(tl, jl)
    for k in st:
        _close(st[k], jst[k])
    assert all(torch.equal(st[k], v) for k, v in cross.items())


# -- (d) the fused paged steps, full precision and int8 ----------------------------------


def _paged_setup(jmodel, jparams, model, params, fills, span, page=4, max_len=24, seed=11):
    """Slots prefilled one by one (fill 0: idle, an all-scratch table row),
    their self-attention rows scattered into fused pools (L, 1, KH, n_pages,
    page, hd) through permuted tables (page 0 the scratch page), their cross
    K/V stacked into a tails-only state. Returns (tails, pools, tables) as
    numpy."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    width = max_len // page
    need = [-(-(n + span) // page) if n else 0 for n in fills]
    n_pages = 1 + sum(need) + 2
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((len(fills), width), np.int32)
    for i, u in enumerate(need):
        tables[i, :u] = perm[:u]
        perm = perm[u:]
    jst, _ = _prefilled(jmodel, jparams, model, params, [max(n, 1) for n in fills],
                        max_len=max_len, seed=seed)
    tails = {k: np.array(jst[k]) for k in ("cross_k", "cross_v")}
    pools = {n: np.zeros((cfg.n_layers, 1, cfg.n_kv_heads, n_pages, page, cfg.hd),
                         np.float32) for n in ("k", "v")}
    for i, n in enumerate(fills):
        for leaf in pools:
            rows = np.asarray(jst[leaf])[:, i, :, :n]                 # (L, KH, n, hd)
            for r in range(n):
                pools[leaf][:, 0, :, tables[i, r // page], r % page] = rows[:, :, r]
    return tails, pools, tables


def _int8(pools, rng):
    """The pools as absmax int8 payloads plus (..., 1) float32 scales."""
    out = {}
    for n, a in pools.items():
        scale = np.maximum(np.abs(a).max(-1, keepdims=True), 1e-3) / 127.0
        out[n] = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        out[f"{n}__scale"] = (scale * rng.uniform(0.9, 1.1, scale.shape)).astype(np.float32)
    return out


def _written(tables, pos, span, page):
    return {(int(tables[i, (p + j) // page]), (p + j) % page)
            for i, p in enumerate(pos) for j in range(span)}


@pytest.mark.parametrize("int8", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_steps_match_the_reference(pair, kind, int8):
    """One fused paged decode step and a verify span of 4 at per-slot
    positions (fills 13, 6 and an idle slot) through both models: the
    self-attention off the pools, the cross-attention against the tails.
    Logits, the pools (written in place), the tails untouched."""
    jmodel, jparams, model, params = pair
    fills = [13, 6, 0]
    span = 1 if kind == "decode" else 4
    tails, pools, tables = _paged_setup(jmodel, jparams, model, params, fills, span)
    if int8:
        pools = _int8(pools, np.random.default_rng(13))
    tokens = np.random.default_rng(12).integers(0, model.cfg.vocab, (3, span)).astype(np.int32)
    pos = np.asarray(fills, np.int32)
    jfn = jmodel.decode_step_paged if kind == "decode" else jmodel.verify_step_paged
    fn = model.decode_step_paged if kind == "decode" else model.verify_step_paged
    want_logits, _, want_pools = jfn(jparams, {k: jnp.asarray(v) for k, v in tails.items()},
                                     {k: jnp.asarray(v) for k, v in pools.items()},
                                     jnp.asarray(tables), jnp.asarray(tokens),
                                     jnp.asarray(pos))
    got_tails = {k: _t(v) for k, v in tails.items()}
    got_pools = {k: _t(v) for k, v in pools.items()}
    logits, out_tails, out_pools = fn(params, got_tails, got_pools, _t(tables), _t(tokens),
                                      _t(pos))
    assert out_tails is got_tails and out_pools is got_pools       # in place
    assert all(torch.equal(got_tails[k], _t(v)) for k, v in tails.items())
    tol = INT8_TOL if int8 else ATOL
    _close(logits, want_logits, tol, tol)
    if not int8:
        for leaf in pools:
            _close(got_pools[leaf], want_pools[leaf])
        return
    written = _written(tables, pos, span, pools["k"].shape[-2])
    for n in pools:
        got, want = got_pools[n].numpy(), np.asarray(want_pools[n])
        if n.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            n_written = len(written) * int(np.prod(got.shape[:-3])) * got.shape[-1]
            assert diff.max() <= 1 and (diff > 0).sum() <= 0.01 * n_written
        lead = got.ndim - 3
        changed = np.argwhere((got != pools[n]).any(axis=tuple(range(lead)) + (got.ndim - 1,)))
        assert {tuple(int(i) for i in c) for c in changed} <= written


def test_state_contracts_and_training_refused(pair):
    """The slot axis of every leaf is 1; the self-attention caches page on
    axis 3 and the cross K/V are tails; ``enc_len`` defaults to max_len as
    in the reference; a train batch without its audio frames raises,
    naming them, at the loss and at the train step."""
    _, _, model, params = pair
    st = model.init_decode_state(2, 10)
    assert st["cross_k"].shape[3] == 10
    assert model.state_batch_axes(st) == {k: 1 for k in st}
    assert model.state_page_axes(st) == {"k": 3, "v": 3, "cross_k": None, "cross_v": None}
    assert model.verify_commit is None and model.verify_commit_paged is None
    tokens_only = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                   "labels": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="'audio_embeds'"):
        model.loss(params, tokens_only)
    state = {"params": params, "opt": init_opt_state(OptConfig(), params)}
    with pytest.raises(ValueError, match="'audio_embeds'"):
        make_train_step(model, OptConfig())(state, tokens_only)
