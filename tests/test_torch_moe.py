"""The port's moe family (grok-1-314b and arctic-480b: the lm backbone with
every block's MLP swapped for a capacity-bounded mixture of SwiGLU experts,
arctic with a dense residual MLP beside it) against the JAX reference's
``repro/nn/moe.py`` and ``repro/nn/lm.py``, on the same numpy inputs, with
the reference's params carried across by ``load_jax_params``: the four
``moe.yaml`` primitives against the ``cpu_xla`` library (planted router
ties; a capacity that drops rows), ``moe_forward``'s output and aux term,
and the reduced models' logits, prefill, chunked prefill, decode steps,
verify span and fused paged decode / verify steps.

Reduced configs (the reference's ``reduced()``: 2 layers, d 64, 4 heads of
16 over 2 KV heads, 4 experts of d_ff 128, top-2, vocab 256, float32;
arctic's dense residual 64 wide).

Tolerances (float32 throughout):

- routing (expert ids, slots, the kept mask) and the dispatched rows are
  EXACT: the same float32 logits sort to the same experts, ties to the lower
  index in both;
- the gate weights within 1e-6 (the two libraries' exp round apart), the
  expert FFN, the combine and every model output within 1e-5 absolute +
  1e-5 relative (the same products summed in other orders); the layer's
  output within 1e-5 relative + 1e-5 of its largest magnitude absolute
  (the reference's init scales an expert weight by n_experts ** -0.5, its
  fan-in axis, so the reduced layer's outputs reach ~1e2 and the sums
  cancel to ~1e-1 in places);
- the ``h100`` ``expert_ffn`` on bf16 operands (its products and
  activation rounded to bf16 on the way, as on the card) within 2e-2 of
  the reference's float32 arithmetic on the same bf16 operands, relative
  to the output's largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import moe as jax_moe
from repro.nn.model import build_model as jax_build_model
from repro_torch import tsl_api
from repro_torch.configs import get_config
from repro_torch.core import load_library
from repro_torch.kernels.moe import ref as moe_ref
from repro_torch.nn import moe
from repro_torch.nn.lm import unstack_layers
from repro_torch.nn.model import Model, build_model, load_jax_params
from repro_torch.train import OptConfig, make_train_step

ATOL = RTOL = 1e-5
CHUNK_TOL = 2e-4                  # the reference's own chunked-prefill bar
BF16_REL = 2e-2
ARCHS = ["grok-1-314b", "arctic-480b"]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def libs():
    from repro.core import load_library as jax_load_library

    return load_library("torch_cpu").ops, jax_load_library("cpu_xla").ops


@functools.cache
def _pair(arch):
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture
def grok():
    """The steps past prefill (decode, verify, paged) are held on grok's
    reduced config: arctic's differ only in the MLP the prefill tests
    already hold."""
    return _pair("grok-1-314b")


# -- (a) the four moe.yaml primitives ---------------------------------------------------


@pytest.mark.parametrize("case", ["random", "planted_ties"])
def test_topk_gating_matches_the_reference(libs, case):
    """Expert ids exactly, the lower index first among equal logits as
    ``jax.lax.top_k`` puts them; the renormalized weights within 1e-6. The
    planted ties: integer logits over 8 experts, most rows holding a tie at
    the top-2 boundary."""
    port, ref = libs
    rng = np.random.default_rng(1)
    if case == "random":
        logits = rng.uniform(-3, 3, (64, 8)).astype(np.float32)
    else:
        logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)
        assert sum(np.sort(r)[-2] == np.sort(r)[-3] for r in logits) > 16
    for k in (1, 2, 3):
        jw, jidx = ref.topk_gating(jnp.asarray(logits), k=k)
        w, idx = port.topk_gating(torch.from_numpy(logits), k=k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(w, jw, 1e-6, 1e-6)


@pytest.mark.parametrize("capacity", [32, 5], ids=["keeps_all", "drops"])
def test_dispatch_and_combine_match_the_reference(libs, capacity):
    """The dispatch of 24 tokens' top-2 rows over 4 experts: the (E, C, D)
    block, each row's expert, clipped slot, kept mask and weight exactly,
    and the combine of a stand-in expert output. At capacity 5 about half
    the rows are dropped: zero in the block, zero in the combine."""
    port, ref = libs
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 6)).astype(np.float32)
    logits = rng.normal(size=(24, 4)).astype(np.float32)
    jw, jidx = ref.topk_gating(jnp.asarray(logits), k=2)
    jxe, jinfo = ref.moe_dispatch(jnp.asarray(x), jidx, jw, n_experts=4, capacity=capacity)
    w, idx = port.topk_gating(torch.from_numpy(logits), k=2)
    xe, info = port.moe_dispatch(torch.from_numpy(x), idx, w, n_experts=4, capacity=capacity)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))
    for got, want in zip(info[:3], jinfo[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(info[3], jinfo[3], 1e-6, 1e-6)
    assert info[4] == jinfo[4] == 24
    dropped = int((~info[2]).sum())
    assert (dropped == 0) if capacity == 32 else dropped > 8
    ye = rng.normal(size=xe.shape).astype(np.float32)
    want = ref.moe_combine(jnp.asarray(ye), jinfo)
    _close(port.moe_combine(torch.from_numpy(ye), info), want)


@pytest.mark.parametrize("target", ["torch_cpu", "h100"])
def test_expert_ffn_matches_the_reference(libs, target):
    """torch_cpu: float32 within 1e-5 of the reference's, whole and a block
    of experts at a time (the float32 copies tiled over 3 blocks). h100 (its
    plain version on the host: bmm in the operands' dtype, the activation
    through the swiglu wrapper): on bf16 operands within 2e-2 of the
    reference's float32 arithmetic on the same operands."""
    _, ref = libs
    rng = np.random.default_rng(3)
    e, c, d, f = 5, 8, 16, 24
    xe, wg, wu = (rng.uniform(-1, 1, s).astype(np.float32)
                  for s in ((e, c, d), (e, d, f), (e, d, f)))
    wd = rng.uniform(-1, 1, (e, f, d)).astype(np.float32)
    ops = tsl_api.lib("cpu", target=target).ops
    if target == "torch_cpu":
        want = ref.expert_ffn(*map(jnp.asarray, (xe, wg, wu, wd)))
        _close(ops.expert_ffn(*map(torch.from_numpy, (xe, wg, wu, wd))), want)
        blocks = moe_ref.expert_ffn(*map(torch.from_numpy, (xe, wg, wu, wd)),
                                    block_bytes=2 * 3 * d * f * 4)
        _close(blocks, want)
        return
    bf = [torch.from_numpy(a).bfloat16() for a in (xe, wg, wu, wd)]
    got = ops.expert_ffn(*bf)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.expert_ffn(*(jnp.asarray(a.float().numpy()) for a in bf)))
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err < BF16_REL, err


@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["config", "drops"])
def test_moe_forward_matches_the_reference(pair, factor):
    """One layer's mixture of experts on 2 x 12 tokens, at the config's
    capacity factor (capacity 15 for the 48 rows over 4 experts) and at 0.5
    (capacity 8: about a third of the rows dropped): the output and the aux
    term; arctic's output includes its dense residual MLP."""
    jmodel, jparams, model, params = pair
    jcfg, cfg = jmodel.cfg.replace(capacity_factor=factor), \
        model.cfg.replace(capacity_factor=factor)
    cap = moe.capacity_for(cfg, 24)
    assert cap == jax_moe.capacity_for(jcfg, 24) == (15 if factor > 1 else 8)
    assert moe.capacity_for(cfg, 4) == jax_moe.capacity_for(jcfg, 4) == 8
    x = np.random.default_rng(4).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    jy, jaux = jax_moe.moe_forward(jp, jnp.asarray(x), jcfg)
    p = unstack_layers(params["blocks"], cfg.n_layers)[0]["moe"]
    assert ("dense" in p) == cfg.moe_dense_residual
    y, aux = moe.moe_forward(model.tsl, p, torch.from_numpy(x), cfg)
    _close(y, jy, atol=ATOL * float(np.abs(np.asarray(jy)).max()))
    _close(aux, jaux)
    x2 = torch.from_numpy(x).reshape(24, -1)
    w, idx = model.tsl.topk_gating(model.tsl.matmul(x2, p["router"]), k=2)
    _, info = model.tsl.moe_dispatch(x2, idx, w, n_experts=4, capacity=cap)
    dropped = int((~info[2]).sum())
    assert dropped > 8 if factor < 1 else dropped == 0


# -- (b) the reduced models ---------------------------------------------------------------


def test_forward_logits_and_prefill_match_the_reference(pair):
    """Teacher-forced logits (greedy argmax equal) and a prefill's last
    logits and caches (padded to max_len)."""
    jmodel, jparams, model, params = pair
    assert type(model) is Model and "moe" in params["blocks"]
    toks = np.random.default_rng(5).integers(0, model.cfg.vocab, (2, 10)).astype(np.int32)
    want = jmodel.forward_logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert np.array_equal(_np(got).argmax(-1), np.asarray(want).argmax(-1))
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    tl, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl)
    for k in ("k", "v"):
        _close(st[k], jst[k])


def test_prefill_chunks_match_the_reference_and_whole_prompt(pair):
    """A 9-token prompt in chunks of 4 (the last one ragged: one real row,
    three padding rows that route through the experts as the reference's
    do): each chunk's logits and the caches against the reference's, the
    last real row against whole-prompt prefill within its 2e-4."""
    jmodel, jparams, model, params = pair
    toks = np.random.default_rng(6).integers(0, model.cfg.vocab, (1, 9)).astype(np.int32)
    padded = np.zeros((1, 12), np.int32)
    padded[:, :9] = toks
    jst = jmodel.init_decode_state(1, 16)
    st = model.init_decode_state(1, 16)
    for c0 in (0, 4, 8):
        seg = padded[:, c0:c0 + 4]
        jl, jst = jmodel.prefill_chunk(jparams, jst, jnp.asarray(seg), c0, c0)
        tl, out = model.prefill_chunk(params, st, torch.from_numpy(seg), c0)
        assert out is st
        _close(tl, jl)
        for k in st:
            _close(st[k], jst[k])
    whole, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_allclose(_np(tl)[:, 0], _np(whole), atol=CHUNK_TOL, rtol=CHUNK_TOL)


def _prefilled(jmodel, jparams, model, fills, max_len=24, seed=3):
    """Slots prefilled one by one at their own fills: the reference's
    batched state as numpy."""
    jst = jmodel.init_decode_state(len(fills), max_len)
    for i, n in enumerate(fills):
        toks = np.random.default_rng(seed + i).integers(0, model.cfg.vocab, (1, n))
        _, one = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len)
        jst = jmodel.insert_slot(jst, one, i)
    return {k: np.array(v) for k, v in jst.items()}


def test_decode_steps_and_verify_span_match_the_reference(grok):
    """Three greedy decode steps at per-slot positions (fills 9 and 5), then
    a verify span of 4 rows (8 rows route together at capacity 8): logits,
    greedy tokens and the caches after each."""
    jmodel, jparams, model, params = grok
    fills = [9, 5]
    jst = _prefilled(jmodel, jparams, model, fills)
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


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_steps_match_the_reference(grok, kind):
    """One fused paged decode step and a verify span of 4 at per-slot
    positions (fills 13, 6 and an idle slot on an all-scratch table row,
    whose rows route with the others) off pools scattered through permuted
    tables: logits and the pools written in place."""
    jmodel, jparams, model, params = grok
    cfg = model.cfg
    fills, span, page, max_len = [13, 6, 0], 1 if kind == "decode" else 4, 4, 24
    rng = np.random.default_rng(11)
    need = [-(-(n + span) // page) if n else 0 for n in fills]
    n_pages = 1 + sum(need) + 2
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((len(fills), max_len // page), np.int32)
    for i, u in enumerate(need):
        tables[i, :u], perm = perm[:u], perm[u:]
    jst = _prefilled(jmodel, jparams, model, [max(n, 1) for n in fills], max_len)
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


def test_state_contracts_and_training_refused(pair):
    """The lm backbone's KV contracts; training raises, citing queue 1 item
    15, at the loss and at the train step."""
    _, _, model, params = pair
    st = model.init_decode_state(2, 10)
    assert model.state_batch_axes(st) == {"k": 1, "v": 1}
    assert model.state_page_axes(st) == {"k": 3, "v": 3}
    assert model.verify_commit is None and model.verify_commit_paged is None
    with pytest.raises(NotImplementedError, match="item 15"):
        model.loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64),
                            "labels": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(NotImplementedError, match="item 15"):
        make_train_step(model, OptConfig())
