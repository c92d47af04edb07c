"""The port's dense lm family against the JAX reference on qwen1.5-0.5b
--reduced (2 layers, d=64, f32), both running the reference's own params
(``build_model(cfg).init(PRNGKey(0))`` -> numpy -> ``load_jax_params``).

Logits are compared in f32 within 1e-4 absolute + 1e-4 relative (the two
frameworks sum and round in different orders through two layers; agreement
is a few f32 ulps of the logit scale). Greedy tokens must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.nn.model import build_model, load_jax_params

ATOL = RTOL = 1e-4
ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params, cfg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def _prompt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_load_jax_params_is_one_to_one(pair):
    jmodel, jparams, model, params, cfg = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree.leaves(jax.tree.map(np.asarray, jparams)))
    for path, leaf in flat_j:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError):
        bad = jax.tree.map(np.asarray, jparams)
        bad["blocks"]["attn"]["wq"] = bad["blocks"]["attn"]["wq"][..., :-1]
        load_jax_params(bad, cfg, "cpu")


def test_forward_logits_match(pair):
    jmodel, jparams, model, params, cfg = pair
    toks = _prompt(cfg, 2, 12, 0)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_prefill_matches_and_fills_the_cache(pair):
    jmodel, jparams, model, params, cfg = pair
    toks = _prompt(cfg, 2, 9, 1)
    want_logits, want_state = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    got_logits, got_state = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    _close(got_logits, want_logits)
    for leaf in ("k", "v"):
        assert tuple(got_state[leaf].shape) == want_state[leaf].shape
        _close(got_state[leaf], want_state[leaf])


def test_prefill_chunk_ragged_matches(pair):
    """A 9-token prompt in chunks of 4 (the last chunk has n_real=1 and three
    padding rows): every chunk's logits at its real rows and the final cache
    rows match the reference."""
    jmodel, jparams, model, params, cfg = pair
    prompt_len, chunk, max_len = 9, 4, 16
    toks = np.zeros((1, 12), np.int32)
    toks[:, :prompt_len] = _prompt(cfg, 1, prompt_len, 2)
    jstate = jmodel.init_decode_state(1, max_len)
    state = model.init_decode_state(1, max_len)
    for c0 in range(0, 12, chunk):
        n_real = max(0, min(prompt_len - c0, chunk))
        seg = toks[:, c0:c0 + chunk]
        jl, jstate = jmodel.prefill_chunk(jparams, jstate, jnp.asarray(seg), c0, c0,
                                          n_real=n_real)
        tl, state = model.prefill_chunk(params, state, torch.from_numpy(seg), c0)
        _close(tl[:, :n_real], np.asarray(jl)[:, :n_real])
    for leaf in ("k", "v"):
        _close(state[leaf][:, :, :, :prompt_len],
               np.asarray(jstate[leaf])[:, :, :, :prompt_len])


def test_greedy_decode_matches_reference_tokens(pair):
    """Prompt arange(16), init(PRNGKey(0)): the reference decodes
    [78, 80, 177, 33] after the prefill token; the port must emit the same
    tokens, step for step, with matching logits."""
    jmodel, jparams, model, params, cfg = pair
    toks = np.arange(16, dtype=np.int32)[None]
    jl, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    tl, state = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    jt = int(np.asarray(jl)[0, :cfg.vocab].argmax())
    tt = int(tl[0, :cfg.vocab].argmax())
    jout, tout = [], []
    for i in range(5):
        assert tt == jt
        jout.append(jt)
        tout.append(tt)
        jl, jstate = jmodel.decode_step(jparams, jstate, jnp.asarray([[jt]], jnp.int32),
                                        jnp.int32(16 + i))
        tl, state = model.decode_step(params, state, torch.tensor([[tt]]), 16 + i)
        _close(tl, jl)
        jt = int(np.asarray(jl)[0, :cfg.vocab].argmax())
        tt = int(tl[0, :cfg.vocab].argmax())
    assert tout[1:] == [78, 80, 177, 33]


def test_per_slot_decode_and_slot_surgery_match(pair):
    """A batched decode step at a (B,) vector of per-slot positions after
    grafting two prefills of different lengths into slots 1 and 0."""
    jmodel, jparams, model, params, cfg = pair
    max_len = 16
    jstate = jmodel.init_decode_state(3, max_len)
    state = model.init_decode_state(3, max_len)
    fills = {1: 7, 0: 4}
    for slot, n in fills.items():
        toks = _prompt(cfg, 1, n, 10 + slot)
        _, jd = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
        _, td = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len)
        jstate = jmodel.insert_slot(jstate, jd, slot)
        state = model.insert_slot(state, td, slot)
    pos = np.asarray([4, 7, 0], np.int32)
    step_toks = np.asarray([[5], [9], [0]], np.int32)
    jl, jstate = jmodel.decode_step(jparams, jstate, jnp.asarray(step_toks),
                                    jnp.asarray(pos))
    tl, state = model.decode_step(params, state, torch.from_numpy(step_toks),
                                  torch.from_numpy(pos))
    _close(tl, jl)
    for leaf in ("k", "v"):
        _close(state[leaf], jstate[leaf])
    state = model.reset_slot(state, 1)
    assert torch.count_nonzero(state["k"][:, 1]) == 0
    assert torch.count_nonzero(state["k"][:, 0]) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registered_arch_matches_the_reference(arch):
    """Every config the port registers builds and runs: the --reduced config's
    logits on the reference's params match (qwen3's qk_norm and GQA, the
    others' full widths cut to the same tiny shape)."""
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = _prompt(cfg, 2, 10, 3)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


@pytest.mark.parametrize("change", [{"family": "moe"}, {"family": "ssm"},
                                    {"family": "hybrid"}, {"family": "vlm"},
                                    {"family": "audio", "act": "gelu",
                                     "norm": "layernorm"}])
def test_build_model_refuses_families_not_ported(change):
    cfg = get_config(ARCH).reduced().replace(**change)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, device="cpu")
