"""The port's vlm family (internvl2-2b: the lm backbone reading a request's
projected patch embeddings AHEAD of its first prompt token) against the JAX
reference's ``repro/nn/lm.py``, on the same numpy inputs, with the
reference's params carried across by ``load_jax_params`` (``vision_proj``
among them): the teacher-forced logits with and without the vision rows,
prefill, chunked prefill (the first chunk with the embeddings, ragged later
chunks, at the schedules of ``tests/test_serve_chunked.py:35-95``), decode
steps past the vision rows, the verify span, and the fused paged decode and
verify steps.

Reduced internvl2-2b (the reference's ``reduced()``: 2 layers, d 64, 4
heads of 16 over 2 KV heads, d_ff 128, vocab 256, 8 vision rows, float32).

Tolerances (float32 throughout): the model's outputs and state leaves within
1e-5 absolute + 1e-5 relative of the reference's (the same products summed
in other orders), greedy tokens identical; chunked prefill against
whole-prompt prefill within the reference test's 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.nn.model import Model, build_model, load_jax_params
from repro_torch.train import OptConfig, make_train_step

ARCH = "internvl2-2b"
ATOL = RTOL = 1e-5
CHUNK_TOL = 2e-4                  # the reference's own chunked-prefill bar


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


def _inputs(cfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    vision = rng.normal(size=(b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return toks, vision


def _batches(toks, vision):
    jb, b = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if vision is not None:
        jb["vision_embeds"] = jnp.asarray(vision)
        b["vision_embeds"] = torch.from_numpy(vision)
    return jb, b


# -- (a) logits and prefill ----------------------------------------------------------------


@pytest.mark.parametrize("with_vision", [True, False], ids=["vision", "tokens_only"])
def test_forward_logits_match_the_reference(pair, with_vision):
    """vision_prefix + S rows of logits behind the projected patch rows (S
    rows without them, as the reference's ``embed_inputs``); greedy argmax
    equal."""
    jmodel, jparams, model, params = pair
    assert type(model) is Model and params["vision_proj"].shape == (64, 64)
    toks, vision = _inputs(model.cfg)
    jb, b = _batches(toks, vision if with_vision else None)
    want = jmodel.forward_logits(jparams, jb)
    got = model.forward_logits(params, b)
    assert got.shape[1] == 10 + (model.cfg.vision_prefix if with_vision else 0)
    _close(got, want)
    assert np.array_equal(_np(got).argmax(-1), np.asarray(want).argmax(-1))


def test_prefill_matches_the_reference(pair):
    """The last logits and the caches, filled to the 8 vision rows + 10
    prompt rows (padded to max_len)."""
    jmodel, jparams, model, params = pair
    jb, b = _batches(*_inputs(model.cfg))
    jl, jst = jmodel.prefill(jparams, jb, 24)
    tl, st = model.prefill(params, b, 24)
    _close(tl, jl)
    assert st["k"].shape[3] == 24 and torch.count_nonzero(st["k"][:, :, :, 18:]) == 0
    for k in ("k", "v"):
        _close(st[k], jst[k])


# -- (b) chunked prefill, decode steps, the verify span ----------------------------------


@pytest.mark.parametrize("chunk,padded_len", [(1, 9), (3, 9), (4, 12), (16, 16), (4, 16)])
def test_prefill_chunks_match_the_reference_and_whole_prompt(pair, chunk, padded_len):
    """A 9-token prompt behind its vision rows in chunks
    (``tests/test_serve_chunked.py:35-95``): chunk 1, a ragged last chunk,
    one chunk past the prompt, and a bucket whose last two chunks are all
    padding. The first chunk carries the embeddings (its logits have the
    8 vision rows first); each chunk's logits and the caches against the
    reference's ``prefill_chunk``; the last real row against whole-prompt
    prefill within 2e-4; a decode step from the chunked state leaves the
    vision and prompt rows as they were and matches the reference's from
    its whole-prompt state."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    toks, vision = _inputs(cfg, b=1, s=9, seed=2)
    padded = np.zeros((1, padded_len), np.int32)
    padded[:, :9] = toks
    jst = jmodel.init_decode_state(1, 32)
    st = model.init_decode_state(1, 32)
    fill, last = 0, None
    for ci in range(padded_len // chunk):
        seg = padded[:, ci * chunk:(ci + 1) * chunk]
        n_real = max(0, min(9 - ci * chunk, chunk))
        emb = vision if ci == 0 else None
        jl, jst = jmodel.prefill_chunk(jparams, jst, jnp.asarray(seg), fill, fill,
                                       embeds=None if emb is None else jnp.asarray(emb))
        tl, st = model.prefill_chunk(params, st, torch.from_numpy(seg), fill,
                                     embeds=None if emb is None else torch.from_numpy(emb))
        _close(tl, jl)
        pr = tl.shape[1] - chunk
        assert pr == (cfg.vision_prefix if ci == 0 else 0)
        fill += pr
        if n_real:
            last = _np(tl)[:, pr + n_real - 1]
            fill += n_real
    assert fill == 9 + cfg.vision_prefix
    for k in st:
        _close(st[k], jst[k])
    jb, b = _batches(toks, vision)
    jwhole, jstate = jmodel.prefill(jparams, jb, 32)
    np.testing.assert_allclose(last, np.asarray(jwhole), atol=CHUNK_TOL, rtol=CHUNK_TOL)
    nxt = np.asarray(jwhole)[:, :cfg.vocab].argmax(-1)[:, None].astype(np.int32)
    jl, _ = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt), jnp.int32(fill))
    kept = st["k"][:, :, :, :fill].clone()
    tl, st = model.decode_step(params, st, torch.from_numpy(nxt), fill)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=CHUNK_TOL, rtol=CHUNK_TOL)
    assert torch.equal(st["k"][:, :, :, :fill], kept)


def _prefilled(jmodel, jparams, cfg, fills, max_len=32, seed=3):
    """Slots prefilled one by one behind their own vision rows (each slot's
    cache then holds vision_prefix + n rows): the reference's state as
    numpy."""
    jst = jmodel.init_decode_state(len(fills), max_len)
    for i, n in enumerate(fills):
        jb, _ = _batches(*_inputs(cfg, b=1, s=n, seed=seed + i))
        _, one = jmodel.prefill(jparams, jb, max_len)
        jst = jmodel.insert_slot(jst, one, i)
    return {k: np.array(v) for k, v in jst.items()}


def test_decode_steps_and_verify_span_match_the_reference(pair):
    """Three greedy decode steps at per-slot positions past the vision rows
    (fills 8 + 9 and 8 + 5), then a verify span of 4 rows: logits, greedy
    tokens and the caches after each."""
    jmodel, jparams, model, params = pair
    fills = [model.cfg.vision_prefix + n for n in (9, 5)]
    jst = _prefilled(jmodel, jparams, model.cfg, [9, 5])
    st = {k: _t(v) for k, v in jst.items()}
    jst = {k: jnp.asarray(v) for k, v in jst.items()}
    tok = np.asarray([[7], [11]], np.int32)
    for step in range(3):
        pos = np.asarray(fills, np.int32) + step
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok), jnp.asarray(pos))
        tl, st = model.decode_step(params, st, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(_np(tl).argmax(-1)[:, None], tok)
    span = np.random.default_rng(5).integers(0, model.cfg.vocab, (2, 4)).astype(np.int32)
    pos = np.asarray(fills, np.int32) + 3
    jl, jst = jmodel.verify_step(jparams, jst, jnp.asarray(span), jnp.asarray(pos))
    tl, st = model.verify_step(params, st, torch.from_numpy(span), torch.from_numpy(pos))
    _close(tl, jl)
    for k in st:
        _close(st[k], jst[k])


# -- (c) the fused paged steps -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_steps_match_the_reference(pair, kind):
    """One fused paged decode step and a verify span of 4 at per-slot
    positions (cache fills 8 + 13, 8 + 6 and an idle slot on an all-scratch
    table row) off pools scattered through permuted tables: logits and the
    pools written in place."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    prompts = [13, 6, 0]
    fills = [cfg.vision_prefix + n if n else 0 for n in prompts]
    span, page, max_len = (1 if kind == "decode" else 4), 4, 32
    rng = np.random.default_rng(11)
    need = [-(-(n + span) // page) if n else 0 for n in fills]
    n_pages = 1 + sum(need) + 2
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((len(fills), max_len // page), np.int32)
    for i, u in enumerate(need):
        tables[i, :u], perm = perm[:u], perm[u:]
    jst = _prefilled(jmodel, jparams, cfg, [max(n, 1) for n in prompts], max_len)
    pools = {n: np.zeros((cfg.n_layers, 1, cfg.n_kv_heads, n_pages, page, cfg.hd),
                         np.float32) for n in ("k", "v")}
    for i, n in enumerate(fills):
        for leaf in pools:
            for r in range(n):
                pools[leaf][:, 0, :, tables[i, r // page], r % page] = jst[leaf][:, i, :, r]
    tokens = rng.integers(0, cfg.vocab, (3, span)).astype(np.int32)
    pos = np.asarray(fills, np.int32)
    jfn = jmodel.decode_step_paged if kind == "decode" else jmodel.verify_step_paged
    fn = model.decode_step_paged if kind == "decode" else model.verify_step_paged
    want, _, want_pools = jfn(jparams, {}, {k: jnp.asarray(v) for k, v in pools.items()},
                              jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(pos))
    got_pools = {k: _t(v) for k, v in pools.items()}
    logits, _, out = fn(params, {}, got_pools, _t(tables), _t(tokens), _t(pos))
    assert out is got_pools
    _close(logits, want)
    for leaf in pools:
        _close(got_pools[leaf], want_pools[leaf])


def test_contracts_refusals_and_training_refused(pair):
    """The lm backbone's KV contracts (the vision rows page like prompt
    rows); the decode prefix is the vision prefix; a vlm config without
    vision rows is refused at ``build_model``; training raises, citing
    queue 1 item 14, at the loss and at the train step."""
    _, _, model, params = pair
    cfg = model.cfg
    assert cfg.decode_prefix == cfg.vision_prefix == 8
    st = model.init_decode_state(2, 10)
    assert model.state_page_axes(st) == {"k": 3, "v": 3}
    assert model.verify_commit is None and model.verify_commit_paged is None
    with pytest.raises(NotImplementedError, match="vision_prefix=0 is not ported"):
        build_model(cfg.replace(vision_prefix=0), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        model.loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                            "labels": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(NotImplementedError, match="item 14"):
        make_train_step(model, OptConfig())
