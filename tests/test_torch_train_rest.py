"""The rest of the port's training against the JAX reference on the host:
int8 optimizer moments, microbatch gradient accumulation, int8 gradient
compression with error feedback, and the token data pipeline. Inputs are
numpy arrays drawn from a seed and handed to both frameworks.

Tolerances, per test:

* ``_quantize`` / ``quantize_absmax_int8`` after one quantization: ``q``
  exactly equal (the same float32 division and round-half-to-even),
  ``scale`` rel <= 1e-7 (one float32 rounding);
* AdamW with int8 moments over 3 steps: params rel <= 1e-5 per leaf; ``q``
  off by at most 1 anywhere (a moment a few float32 ulps apart may land on
  the other side of a .5 boundary); ``scale`` rel <= 1e-6;
* train steps (microbatches, compression): loss, ce, grad_norm rel <= 1e-4
  and lr rel <= 1e-6, as ``test_torch_train.py::test_train_step_matches_
  reference``; ``compress_err`` rel <= 1e-3: it is a max of per-element
  rounding errors of about amax/254, so the grads' 1e-6-relative agreement
  moves it by up to ~254 times that;
* compression and error feedback on the same float32 input: exactly equal;
* data batches: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.dist import compression as jax_comp
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.data.pipeline import DataState, MemmapTokens, Prefetcher, SyntheticTokens
from repro_torch.dist import compression as comp
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.train import OptConfig, apply_updates, init_opt_state, make_train_step
from repro_torch.train.optimizer import _dequantize, _quantize
from test_torch_train import _batch, _rel, jax_pair


def _node(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _rows(shape, seed=0):
    """Seeded float32 values. Where there are rows, the last puts values
    exactly on .5 boundaries of both scale rules (amax 127: scale 1 under
    max(amax, 1e-12)/127 and amax/127 alike), and where there are two or
    more, the first is all zeros."""
    x = np.random.default_rng(seed).normal(0, 3, shape).astype(np.float32)
    if x.ndim >= 1:
        flat = x.reshape(-1, x.shape[-1])
        flat[-1, :6] = BOUNDARY
        if len(flat) > 1:
            flat[0] = 0.0
    return x


BOUNDARY = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]


SHAPES = [(), (7,), (5, 9), (3, 4, 6)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_moment_quantize_matches_reference(shape):
    x = _rows(shape)
    got, want = _quantize(torch.from_numpy(x)), jax_opt._quantize(jnp.asarray(x))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["scale"].shape == want["scale"].shape
    assert _rel(got["scale"].numpy(), want["scale"]) <= 1e-7
    back = _dequantize(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_opt._dequantize(want)),
                               rtol=1e-7, atol=0)
    if len(shape) >= 1:
        assert got["q"].numpy().reshape(-1, shape[-1])[-1, :6].tolist() == \
            [127, 0, 2, 2, -2, 0]                    # round half to even


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_absmax_int8_matches_reference(shape):
    x = _rows(shape, seed=1)
    if not shape:                        # no last axis: both frameworks refuse
        with pytest.raises(ValueError):
            jax_comp.quantize_absmax_int8(jnp.asarray(x))
        with pytest.raises(ValueError):
            comp.quantize_absmax_int8(torch.from_numpy(x))
        return
    q, scale = comp.quantize_absmax_int8(torch.from_numpy(x))
    jq, jscale = jax_comp.quantize_absmax_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _rel(scale.numpy(), jscale) <= 1e-7
    if len(shape) >= 2:
        assert float(scale.reshape(-1)[0]) == 1.0               # all-zero row
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = comp.dequantize_absmax_int8(q, scale, dt)
        want = np.asarray(jax_comp.dequantize_absmax_int8(jq, jscale, jdt), np.float32)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)


def _seeded_grads(jparams, rng, norm):
    raw = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                        for x in jax.tree.leaves(raw)))
    return jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), raw)


def test_int8_apply_updates_matches_reference():
    """Three AdamW steps with int8 moments on reduced qwen1.5's params, with
    seeded grads of global norm 0.5, 2 and 5 (below, then above the clip)."""
    _, jparams, cfg, params = jax_pair("qwen1.5-0.5b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, moment_dtype="int8")
    jcfg, tcfg = jax_opt.OptConfig(**kw), OptConfig(**kw)
    jstate, tstate = jax_opt.init_opt_state(jcfg, jparams), init_opt_state(tcfg, params)
    for name in ("m", "v"):                      # quantized zeros, as the reference's
        for path, leaf in jax.tree_util.tree_leaves_with_path(jstate[name]):
            np.testing.assert_array_equal(_node(tstate[name], path).numpy(), leaf)
    rng = np.random.default_rng(11)
    jupdate = jax.jit(lambda p, g, s: jax_opt.apply_updates(jcfg, p, g, s))
    worst_q = 0
    for step, norm in enumerate((0.5, 2.0, 5.0)):
        raw = _seeded_grads(jparams, rng, norm)
        jparams, jstate, jm = jupdate(jparams, raw, jstate)
        params, tstate, tm = apply_updates(tcfg, params, load_jax_params(raw, cfg, "cpu"),
                                           tstate)
        assert _rel(tm["grad_norm"].item(), jm["grad_norm"]) <= 1e-6
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
            assert _rel(_node(params, path).numpy(), leaf) <= 1e-5, (step, path)
        for name in ("m", "v"):
            for path, leaf in jax.tree_util.tree_leaves_with_path(jstate[name]):
                got = _node(tstate[name], path)
                if path[-1].key == "q":
                    assert got.dtype == torch.int8
                    off = np.abs(got.numpy().astype(np.int32) - np.asarray(leaf, np.int32))
                    worst_q = max(worst_q, int(off.max()))
                else:
                    assert _rel(got.numpy(), leaf) <= 1e-6, (step, name, path)
    assert worst_q <= 1


def _run_both(opt_kw, steps, seed=5, b=4, **step_kw):
    """``steps`` train steps of the reference (jitted) and the port from the
    reference's reduced qwen1.5 params on one seeded (b, 16) batch: the
    metrics of each step, both ways."""
    jmodel, jparams, cfg, params = jax_pair("qwen1.5-0.5b")
    jcfg, tcfg = jax_opt.OptConfig(**opt_kw), OptConfig(**opt_kw)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, **step_kw))
    tstep = make_train_step(build_model(cfg, device="cpu"), tcfg, **step_kw)
    batch = _batch(cfg, seed=seed, b=b)
    jstate = {"params": jparams, "opt": jax_opt.init_opt_state(jcfg, jparams)}
    tstate = {"params": params, "opt": init_opt_state(tcfg, params)}
    out = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((tm, jm))
    return out


def _check_metrics(tm, jm):
    for key in ("loss", "ce", "grad_norm"):
        assert _rel(tm[key].item(), jm[key]) <= 1e-4, (key, tm[key], jm[key])
    assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    if "compress_err" in jm:
        assert tm["compress_err"].dtype == torch.float32 and tm["compress_err"].ndim == 0
        assert _rel(tm["compress_err"].item(), jm["compress_err"]) <= 1e-3, \
            (tm["compress_err"], jm["compress_err"])


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_train_step_matches_reference(microbatches):
    """make_train_step(microbatches=k) for 3 steps on a batch of 4 rows: the
    mean of the parts' losses, the float32-accumulated grads' norm, lr."""
    runs = _run_both(dict(lr=3e-3, warmup_steps=0, total_steps=10), 3,
                     microbatches=microbatches)
    for tm, jm in runs:
        _check_metrics(tm, jm)
    assert runs[2][0]["loss"].item() < runs[0][0]["loss"].item()


def test_compress_grads_matches_reference():
    runs = _run_both(dict(lr=3e-3, warmup_steps=0, total_steps=10), 3,
                     compress_grads=True)
    for tm, jm in runs:
        _check_metrics(tm, jm)
        assert tm["compress_err"].item() > 0


def test_int8_compression_and_microbatches_together_match_reference():
    """int8 moments, compression and 2 microbatches at once, with the train
    CLI's schedule for 6 steps (lr 3e-4, warmup 2, total 10). The reference
    diverges from the third step on in this combination (its loss jumps
    about 7x there on the CLI's batch); the port reproduces that arithmetic
    rather than repairing it, so only the two steps before are compared."""
    runs = _run_both(dict(lr=3e-4, warmup_steps=2, total_steps=10, moment_dtype="int8"),
                     2, microbatches=2, compress_grads=True)
    for tm, jm in runs:
        _check_metrics(tm, jm)


def test_int8_moments_diverge_at_full_vocabulary_in_both():
    """int8 moments alone, at qwen1.5's full vocabulary (151936) on reduced
    widths, with 2 microbatches and the train CLI's schedule on
    SyntheticTokens batches of 2 x 16: the reference's loss jumps from the
    third step on (11.92, 11.92, 43.61, 149.9) and the port's follows it,
    while float32 moments stay near 11.9. Per-row absmax quantization zeroes the small
    second moments of an embedding row; a row that then gets a small or no
    gradient takes an update of m / (0 + eps). The port reproduces this
    arithmetic; it does not repair it. Tolerances: steps 1-2 rel 1e-4, as
    above; steps 3-4 rel 1e-3 (the divergence amplifies the frameworks'
    float32 differences; 9e-5 measured)."""
    from repro.configs import get_config as jax_get_config
    from repro.nn.model import build_model as jax_build_model
    from repro_torch.configs import get_config

    vocab = 151936
    jcfg = jax_get_config("qwen1.5-0.5b").reduced().replace(vocab=vocab)
    cfg = get_config("qwen1.5-0.5b").reduced().replace(vocab=vocab)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    source = SyntheticTokens(vocab, 2, 16, seed=0)
    batches = [source.batch_at(i) for i in range(4)]
    kw = dict(lr=3e-4, total_steps=10, warmup_steps=2)
    losses = {}
    for md in ("float32", "int8"):
        tcfg = OptConfig(**kw, moment_dtype=md)
        tstep = make_train_step(build_model(cfg, device="cpu"), tcfg, microbatches=2)
        tstate = {"params": params, "opt": init_opt_state(tcfg, params)}
        for b in batches:
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.setdefault(md, []).append(tm["loss"].item())
    jcfg_opt = jax_opt.OptConfig(**kw, moment_dtype="int8")
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg_opt, microbatches=2))
    jstate = {"params": jparams, "opt": jax_opt.init_opt_state(jcfg_opt, jparams)}
    want = []
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jm["loss"]))
    for i, (got, w) in enumerate(zip(losses["int8"], want)):
        assert _rel(got, w) <= (1e-4 if i < 2 else 1e-3), (i, losses["int8"], want)
    assert want[3] > 2 * want[0] and losses["int8"][3] > 2 * losses["int8"][0]
    assert max(losses["float32"]) < 1.01 * losses["float32"][0]


def test_microbatches_must_divide_the_batch():
    _, _, cfg, params = jax_pair("qwen1.5-0.5b")
    step = make_train_step(build_model(cfg, device="cpu"), OptConfig(), microbatches=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=4).items()}
    with pytest.raises(ValueError, match="not divisible"):
        step({"params": params, "opt": init_opt_state(OptConfig(), params)}, batch)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 2, (6, 10)).astype(np.float32),
            "b": {"x": rng.normal(0, 1e-3, (10,)).astype(np.float32),
                  "z": np.zeros((2, 3, 4), np.float32)}}


def _to_torch(tree, dtype=torch.float32):
    return {k: _to_torch(v, dtype) if isinstance(v, dict) else
            torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def test_compress_decompress_matches_reference():
    """Every leaf round-tripped and cast back to its own dtype (float32 and
    bfloat16), and the max abs error, equal to the reference's."""
    tree = _grad_tree(2)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        out, err = comp.compress_decompress(_to_torch(tree, dt))
        jtree = jax.tree.map(lambda x: jnp.asarray(x, jdt), tree)
        jout, jerr = jax_comp.compress_decompress(jtree)
        assert err.dtype == torch.float32 and err.ndim == 0
        assert err.item() == float(jerr)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jout):
            got = _node(out, path)
            assert got.dtype == dt
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf, np.float32))
    out, err = comp.compress_decompress({})
    assert err.item() == 0.0 and out == {}


def test_error_feedback_matches_reference():
    """Two rounds of ErrorFeedback.apply on float32 and bfloat16 grads: the
    quantized tree and the residual equal the reference's, and the identity
    quantized + new_residual == tree + residual holds exactly."""
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        res = comp.ErrorFeedback.init(_to_torch(_grad_tree(0), dt))
        jres = jax_comp.ErrorFeedback.init(jax.tree.map(jnp.asarray, _grad_tree(0)))
        for seed in (3, 4):
            g = _to_torch(_grad_tree(seed), dt)
            jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), _grad_tree(seed))
            q, new_res = comp.ErrorFeedback.apply(g, res)
            jq, jres = jax_comp.ErrorFeedback.apply(jg, jres)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jq):
                got_q, got_r = _node(q, path), _node(new_res, path)
                assert got_q.dtype == dt and got_r.dtype == torch.float32
                np.testing.assert_array_equal(got_q.float().numpy(),
                                              np.asarray(leaf, np.float32))
                np.testing.assert_array_equal(got_r.numpy(), np.asarray(_node(jres, path)))
                assert torch.equal(got_q.float() + got_r,
                                   _node(g, path).float() + _node(res, path))
            res = new_res


@pytest.mark.parametrize("shard", [0, 1])
def test_synthetic_tokens_bit_equal_to_reference(shard):
    kw = dict(seed=3, shard=shard, n_shards=2)
    src = SyntheticTokens(151936, 8, 64, **kw)
    ref = jax_pipeline.SyntheticTokens(151936, 8, 64, **kw)
    for step in range(4):
        got, want = src.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int32 and got[k].shape == (4, 64)
            np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(src.batch_at(0)["tokens"], src.batch_at(1)["tokens"])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
@pytest.mark.parametrize("shard", [0, 1])
def test_memmap_tokens_bit_equal_to_reference(tmp_path, dtype, shard):
    path = tmp_path / f"tokens.{dtype}"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(dtype).tofile(path)
    kw = dict(dtype=dtype, seed=1, shard=shard, n_shards=2)
    src, ref = MemmapTokens(path, 6, 33, **kw), jax_pipeline.MemmapTokens(path, 6, 33, **kw)
    for step in range(4):
        got, want = src.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int32 and got[k].shape == (3, 33)
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_order_and_state():
    """From DataState(step=5), get() returns batches 5, 6, 7 in order, as the
    reference's Prefetcher does, and leaves state.step past the last one;
    stop() joins the thread."""
    src = SyntheticTokens(1000, 2, 8, seed=9)
    ref = jax_pipeline.Prefetcher(jax_pipeline.SyntheticTokens(1000, 2, 8, seed=9),
                                  jax_pipeline.DataState(step=5))
    state = DataState(step=5)
    pf = Prefetcher(src, state, depth=2)
    try:
        for step in (5, 6, 7):
            got, want = pf.get(), ref.get()
            np.testing.assert_array_equal(got["tokens"], src.batch_at(step)["tokens"])
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            assert state.step == ref.state.step == step + 1
        assert DataState.from_dict(state.as_dict()) == state
    finally:
        pf.stop()
        ref.stop()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_what_the_source_raised():
    class Broken:
        def batch_at(self, step):
            raise OSError(f"disk gone at {step}")

    pf = Prefetcher(Broken(), DataState(step=2))
    try:
        with pytest.raises(RuntimeError, match="step 2") as info:
            pf.get()
        assert isinstance(info.value.__cause__, OSError)
    finally:
        pf.stop()
    assert not pf._thread.is_alive()
