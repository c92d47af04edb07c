"""The port's training slice against the JAX reference on the host: the flash
attention backward (the plain versions of the three kernels and the
``FlashAttention`` autograd glue), cross-entropy, ``Model.loss`` and every
gradient leaf, AdamW, and the train step. Inputs are numpy arrays drawn
from a seed and handed to both frameworks.

The reference's Pallas kernels do not run on this host (ROADMAP §3), so the
port is held against ``repro.kernels.flash_attention.ref.attention`` through
``jax.vjp`` (the ``cpu_xla`` ``flash_attention_bwd`` definition) and against
``jax.value_and_grad(model.loss)`` on the ``cpu_xla`` library.

Tolerances are the scale-relative gates of ``repro_torch.gates`` (per
tensor: rel = ||got - want|| / ||want|| and |got - want| <= A rms(want) +
R |want| elementwise):

* attention grads, f32: host_f32 (rel 1e-5, A 1e-4, R 1e-5): the two
  frameworks' f32 sums in another order;
* attention grads, bf16 inputs (f32 math inside, bf16 out): host_bf16 (rel
  1e-2, A 2e-2, R 2^-7): one bf16 rounding of the result, plus the port's
  delta taken from the bf16-rounded output, as the reference kernel does;
* loss and grad leaves of a reduced model, f32: model_f32 (rel 1e-4, A
  1e-3, R 1e-4): two layers of f32 round-off in two frameworks;
* the logsumexp: |got - want| <= 1e-5 max(1, |want|), exactly 0 on rows that
  see no key;
* AdamW state after 3 steps: rel 1e-6 per leaf (the same f32 arithmetic;
  the schedule's scalars in float32 on both sides, numpy's and XLA's);
* train-step losses over 3 steps: 1e-4 relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.nn.model import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import gates
from repro_torch.configs import get_config
from repro_torch.core import load_library
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.nn.model import Model, build_model, load_jax_params
from repro_torch.train import (OptConfig, apply_updates, init_opt_state,
                               loss_and_grads, make_train_step)
from repro_torch.train.optimizer import tree_leaves, tree_map

# the seven shapes of tests/test_flash_attention_grad.py:30-39, whisper's
# cross-attention form (non-causal, Sq < Sk, no kv_len) and zamba2's head dim
FA_CASES = [
    (1, 2, 2, 64, 64, 32, True, None),     # block-multiple causal
    (2, 4, 2, 96, 160, 32, True, None),    # GQA + Sq, Sk no multiple of a tile
    (1, 2, 1, 64, 64, 16, False, None),    # MQA non-causal
    (1, 8, 4, 200, 72, 16, True, None),    # Sq > Sk: early rows see no key
    (1, 2, 2, 40, 64, 16, False, 48),      # kv_len-masked cache tail
    (1, 4, 2, 1, 64, 32, True, 40),        # decode shape: Sq 1, kv_len < Sk
    (1, 2, 2, 16, 64, 16, True, 40),       # prefill continuation
    (2, 4, 4, 24, 40, 16, False, None),    # cross-attention: non-causal, Sq < Sk
    (1, 4, 2, 40, 72, 112, True, 64),      # D 112 (zamba2's shared block), GQA, kv_len < Sk
]
GATE = {"float32": "host_f32", "bfloat16": "host_bf16"}


def _operands(case, dt, seed=7):
    """q, k, v, g as torch tensors of ``dt`` and the same values as numpy
    float32 (bf16 rounded once, in torch, then widened exactly)."""
    b, h, kh, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d), (b, h, sq, d)]
    ts = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(getattr(torch, dt))
          for s in shapes]
    return ts, [t.float().numpy() for t in ts]


def _jax_vjp(arrays, dt, causal, kv_len):
    q, k, v, g = (jnp.asarray(a, dtype=dt) for a in arrays)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_fa_ref.attention(
        q_, k_, v_, causal=causal, kv_len=kv_len), q, k, v)
    return out, vjp(g)


_VJP = {}


def _jax_vjp_case(case, dt):
    """_jax_vjp on ``case``'s operands (_operands), computed once a (case,
    dtype): the fault matrix runs the same reference VJPs for every fault."""
    if (case, dt) not in _VJP:
        _VJP[case, dt] = _jax_vjp(_operands(case, dt)[1], dt, case[6], case[7])
    return _VJP[case, dt]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_grads_match_jax(case, dt):
    """FlashAttention.backward (the plain versions of the lse forward, dq and
    dk/dv, with the delta, the head-group sum and the casts) and the
    standalone flash_attention_vjp against jax.vjp(ref.attention)."""
    causal, kv_len = case[6], case[7]
    (q, k, v, g), _ = _operands(case, dt)
    want_out, want = _jax_vjp_case(case, dt)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, kv_len=kv_len)
    assert out.grad_fn is not None and out.dtype == q.dtype
    out.backward(g)
    via_vjp = fa.flash_attention_vjp(q, k, v, g, causal=causal, kv_len=kv_len)
    gates.check(out.detach(), _t(want_out), GATE[dt], "out")
    for name, got, alt, w in zip(("dq", "dk", "dv"), (t.grad for t in leaves), via_vjp,
                                 want):
        assert got.dtype == alt.dtype == q.dtype, (name, got.dtype, alt.dtype)
        gates.check(got, _t(w), GATE[dt], f"{name} (Function)")
        gates.check(alt, _t(w), GATE[dt], f"{name} (flash_attention_vjp)")


@pytest.mark.parametrize("case", FA_CASES)
def test_lse_matches_jax_logsumexp(case):
    """The plain lse forward against a jnp logsumexp of the reference's
    masked scores: within 1e-5 max(1, |lse|), exactly 0 on rows that see no
    key."""
    b, h, kh, sq, sk, d, causal, kv_len = case
    (q, k, v, _), (qn, kn, _, _) = _operands(case, "float32")
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, kv_len=kv_len)
    kf = jnp.repeat(jnp.asarray(kn), h // kh, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(qn), kf) / np.sqrt(d)
    end = sk if kv_len is None else kv_len
    kj, qi = jnp.arange(sk)[None, :], jnp.arange(sq)[:, None] + (end - sq)
    seen = (kj < end) & ((kj <= qi) if causal else True)
    lse_j = jax.nn.logsumexp(jnp.where(seen, s, -jnp.inf), axis=-1)
    no_key = ~np.asarray(seen).any(-1)
    want = np.where(no_key, 0.0, np.asarray(lse_j))
    gates.check_lse(lse, torch.from_numpy(want), torch.from_numpy(no_key), "lse")
    assert (case[3] > case[4] and causal) == bool(no_key.any())   # the Sq > Sk case
    gates.check(out, torch.from_numpy(np.asarray(jax_fa_ref.attention(
        *(jnp.asarray(a) for a in _operands(case, "float32")[1][:3]), causal=causal,
        kv_len=kv_len))), "host_f32", "out")


def test_cross_entropy_matches_reference(lib_cpu):
    """torch_cpu cross_entropy (value and gradient of its mean) against the
    reference's cpu_xla definition, f32, rows as wide as a reduced vocab."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 7, 256)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 7)).astype(np.int32)
    ops = load_library("torch_cpu").ops
    lt = torch.from_numpy(logits).requires_grad_()
    got = ops.cross_entropy(lt, torch.from_numpy(labels))
    got.mean().backward()
    want, grad = jax.value_and_grad(
        lambda x: lib_cpu.ops.cross_entropy(x, jnp.asarray(labels)).mean())(
            jnp.asarray(logits))
    want_rows = lib_cpu.ops.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    gates.check(got.detach(), _t(want_rows), "host_f32", "cross_entropy")
    gates.check(lt.grad, _t(grad), "host_f32", "d cross_entropy")
    assert abs(got.mean().item() - float(want)) <= 1e-5 * float(want)


class _FunctionAttention:
    """A library's ops with flash_attention bound to the kernels' wrapper,
    so the model's attention runs FlashAttention (its plain versions on CPU
    tensors) instead of autograd through the plain attention."""

    def __init__(self, ops, flash_attention=fa.flash_attention):
        self._ops, self.flash_attention = ops, flash_attention

    def __getattr__(self, name):
        return getattr(self._ops, name)


def function_model(model: Model, flash_attention=fa.flash_attention) -> Model:
    """``model`` (of any family's class) with its attention through
    :class:`FlashAttention`."""
    lib = type("Lib", (), {"ops": _FunctionAttention(model.lib.ops, flash_attention)})
    return type(model)(cfg=model.cfg, device=model.device, lib=lib)


ENC_LEN = 24      # the audio family's encoder frames against s = 16 tokens: Sq != Sk


def _batch(cfg, seed=0, b=2, s=16):
    """Seeded tokens and labels (b, s), and the family's float32 embedding
    rows: vlm ``vision_embeds`` (b, vision_prefix, d), audio
    ``audio_embeds`` (b, ENC_LEN, d)."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    rows = {"vlm": ("vision_embeds", cfg.vision_prefix),
            "audio": ("audio_embeds", ENC_LEN)}.get(cfg.family)
    if rows is not None:
        batch[rows[0]] = rng.normal(0, 1, (b, rows[1], cfg.d_model)).astype(np.float32)
    return batch


_JAX = {}


def jax_pair(arch):
    """(reference model, its params, port config, port params) per arch."""
    if arch not in _JAX:
        jcfg = jax_get_config(arch).reduced()
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced()
        params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        _JAX[arch] = (jmodel, jparams, cfg, params)
    return _JAX[arch]


def jax_loss_and_grads(arch, remat):
    key = (arch, "grads", remat)
    if key not in _JAX:
        jmodel, jparams, cfg, _ = jax_pair(arch)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        (loss, _), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, batch, remat=remat), has_aux=True)(jparams)
        _JAX[key] = (float(loss), grads)
    return _JAX[key]


def port_loss_and_grads(model, params, batch, remat):
    return loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                          remat=remat)


def check_model_grads(grads, jgrads, gate="model_f32") -> float:
    """Every grad leaf against the reference's; returns the largest rel."""
    worst = 0.0
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        node = grads
        for k in path:
            node = node[k.key]
        m = gates.check(node, _t(leaf), gate, "grad " + "/".join(k.key for k in path))
        worst, n = max(worst, m["rel"]), n + 1
    assert n == len(tree_leaves(grads))
    return worst


@pytest.mark.parametrize("attention", ["torch_cpu", "flash_function"])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-14b"])
def test_model_loss_and_grads_match_jax(arch, remat, attention):
    """Reduced qwen1.5 (MHA, QKV bias) and qwen3-14b (GQA, q/k norm) from the
    reference's own params: the loss and every grad leaf against
    jax.value_and_grad(model.loss). ``flash_function`` runs the attention
    through FlashAttention (the head-group sum inside the model)."""
    jmodel, jparams, cfg, params = jax_pair(arch)
    want_loss, want_grads = jax_loss_and_grads(arch, remat)
    model = build_model(cfg, device="cpu")
    if attention == "flash_function":
        model = function_model(model)
    loss, metrics, grads = port_loss_and_grads(model, params, _batch(cfg), remat)
    assert abs(loss.item() - want_loss) <= 1e-4 * abs(want_loss)
    assert metrics["aux"].item() == 0.0 and metrics["ce"].item() == loss.item()
    check_model_grads(grads, want_grads)


def test_params_require_no_grad_outside_a_step():
    """Serving's params stay plain tensors: init and a train step leave the
    caller's tensors without requires_grad."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg, device="cpu")
    state = {"params": model.init(0)}
    state["opt"] = init_opt_state(OptConfig(), state["params"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    new, _ = make_train_step(model, OptConfig())(state, batch)
    for tree in (state["params"], new["params"]):
        assert not any(t.requires_grad for t in tree_leaves(tree))


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)


def test_apply_updates_matches_reference():
    """Three AdamW steps on reduced qwen1.5's params with seeded grads whose
    global norms are 0.5, 2 and 5 (below, then above the clip): params, m,
    v, grad_norm and lr against the reference's apply_updates, per leaf,
    rel <= 1e-6."""
    _, jparams, cfg, params = jax_pair("qwen1.5-0.5b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = jax_opt.OptConfig(**kw), OptConfig(**kw)
    jstate, tstate = jax_opt.init_opt_state(jcfg, jparams), init_opt_state(tcfg, params)
    rng = np.random.default_rng(11)
    for step, norm in enumerate((0.5, 2.0, 5.0)):
        raw = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
        total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                            for x in jax.tree.leaves(raw)))
        raw = jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), raw)
        jparams, jstate, jm = jax_opt.apply_updates(jcfg, jparams, raw, jstate)
        grads = load_jax_params(raw, cfg, "cpu")
        params, tstate, tm = apply_updates(tcfg, params, grads, tstate)
        assert _rel(tm["grad_norm"].item(), jm["grad_norm"]) <= 1e-6
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6, (step, tm["lr"], float(jm["lr"]))
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for name, got_tree, want_tree in (("params", params, jparams),
                                          ("m", tstate["m"], jstate["m"]),
                                          ("v", tstate["v"], jstate["v"])):
            for path, leaf in jax.tree_util.tree_leaves_with_path(want_tree):
                node = got_tree
                for k in path:
                    node = node[k.key]
                assert _rel(node.numpy(), leaf) <= 1e-6, (step, name, path)


def test_train_step_matches_reference():
    """make_train_step for 3 steps on reduced qwen1.5 from the reference's
    params and one seeded batch: every step's loss (and grad_norm) within
    1e-4 relative of the reference's make_train_step; the loss falls."""
    jmodel, jparams, cfg, params = jax_pair("qwen1.5-0.5b")
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jmodel, jax_opt.OptConfig(**kw)))
    tstep = make_train_step(build_model(cfg, device="cpu"), OptConfig(**kw))
    batch = _batch(cfg, seed=5)
    jstate = {"params": jparams, "opt": jax_opt.init_opt_state(jax_opt.OptConfig(**kw),
                                                               jparams)}
    tstate = {"params": params, "opt": init_opt_state(OptConfig(**kw), params)}
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(tm[key].item(), jm[key]) <= 1e-4, (key, tm[key], jm[key])
        assert tm["aux"].item() == float(jm["aux"]) == 0.0
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        losses.append(tm["loss"].item())
    assert losses[2] < losses[0]


def test_what_is_not_ported_raises():
    """A mesh (make_train_step) and --dp / --tp other than 1 (the train CLI)
    raise, naming the ROADMAP item that adds them; neither silently runs
    something else. int8 moments, microbatches and compression run now:
    tests/test_torch_train_rest.py holds them against the reference."""
    from repro_torch.launch import train as train_cli

    model = build_model(get_config("qwen1.5-0.5b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*queue 1, item 9"):
        make_train_step(model, OptConfig(), mesh=object())
    for flag in ("--dp", "--tp"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*queue 1, item 9"):
            train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                            flag, "2"])
    with pytest.raises(ValueError, match="moment_dtype"):
        OptConfig(moment_dtype="bfloat16")


@pytest.mark.parametrize("name", [
    "test_cross_entropy__matches_numpy__f32",
    "test_cross_entropy__uniform_logits_log_v__f32",
    "test_flash_attention_bwd__grads_match_oracle_causal_gqa__f32",
    "test_flash_attention_bwd__grads_match_oracle_causal_gqa__bf16",
    "test_flash_attention_bwd__grads_match_oracle_noncausal__f32",
    "test_flash_attention_bwd__grads_match_oracle_noncausal__bf16",
])
def test_generated_torch_cpu_training_blocks_pass(name):
    """The generated torch_cpu suite carries the reference's cross_entropy
    and flash_attention_bwd testing blocks, and they pass."""
    lib = load_library("torch_cpu")
    mod = importlib.import_module(lib.__name__ + ".tests.test_generated")
    getattr(mod, name)()


# -- planted faults: each gate must fail on each fault it can see -------------
#
# Each fault is a small edit of the plain versions (ref.py, which the
# kernels mirror) or of the autograd glue (ops.py), applied to a copy of the
# module's source in memory: nothing faulted is written anywhere.
# ``python tests/test_torch_train.py`` prints the whole fault x gate matrix.

FAULTS = {
    "dk_one_head_zeroed": [("ref", "    return dk, dv\n",
                            "    dk[:, -1] = 0.0\n    return dk, dv\n")],
    "gqa_sum_group_0_only": [("ops", ".sum(2).to(", "[:, :, 0].to(")],
    "dq_scale_dropped": [("ref", "* sc).to(q.dtype)", ").to(q.dtype)")],
    "delta_from_bf16_product": [
        ("ops", "delta = (g.float() * out.float()).sum(-1)",
         "delta = (g.float() * out.float()).bfloat16().float().sum(-1)")],
    "lse_not_zeroed_on_rows_without_keys": [
        ("ref", "lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(1e-30)), 0.0)[..., 0]",
         "lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]")],
    "causal_diagonal_off_by_one": [("ref", "seen & (kj <= torch.arange(sq",
                                    "seen & (kj < torch.arange(sq")],
    # the plain mask stays causal when causal=False (whisper's encoder and
    # cross-attention)
    "causal_when_not_causal": [("ref", "    if causal:\n        seen = seen & (kj <=",
                                "    if True:\n        seen = seen & (kj <=")],
    # kv_len defaults to Sq instead of Sk: keys past Sq are masked where
    # Sq < Sk (the cross-attention), rows see keys past Sk where Sq > Sk
    "kv_len_defaults_to_sq": [("ref", "end = sk if kv_len is None else kv_len",
                               "end = sq if kv_len is None else kv_len")],
    # dk/dv summed only over the first Sq key rows (a k-tiled grid sized by
    # Sq): the cross-attention's keys past Sq get no gradient
    "dkv_keys_past_sq_dropped": [("ref", "    return dk, dv\n",
                                  "    dk[:, :, q.shape[2]:] = 0.0\n"
                                  "    dv[:, :, q.shape[2]:] = 0.0\n    return dk, dv\n")],
    # dq and dk written for 96 of 112 columns (a D-112 row stored as a D-96
    # one, or the last of its 14 column tiles dropped)
    "d112_tail_columns_dropped": [
        ("ref", '    return (torch.einsum("bhqk,bhkd->bhqd", ds, _per_query_head(k, q.shape[1]))\n'
                "            * sc).to(q.dtype)\n",
         '    dq = (torch.einsum("bhqk,bhkd->bhqd", ds, _per_query_head(k, q.shape[1]))\n'
         "          * sc).to(q.dtype)\n"
         "    if dq.shape[-1] == 112:\n        dq[..., 96:] = 0.0\n    return dq\n"),
        ("ref", "    return dk, dv\n",
         "    if dk.shape[-1] == 112:\n        dk[..., 96:] = 0.0\n    return dk, dv\n")],
}
# (fault, gate) pairs a gate cannot see, and why: no reduced model's
# attention has a row without keys (causal self-attention at Sq = Sk,
# whisper's encoder and cross-attention non-causal over every key), and the
# plain versions and kernels mask p explicitly, so that lse never enters a
# gradient; no reduced model has head dim 112 (zamba2's reduced shared block
# has 16: its full width is the card's, chip_smoke.py phases 5a and 8e).
BLIND = {("lse_not_zeroed_on_rows_without_keys", "model_f32"),
         ("d112_tail_columns_dropped", "model_f32")}
# the reduced configs model_gate runs: MHA with QKV bias, GQA with q/k norm,
# the vision prefix (GQA) and the encoder-decoder (non-causal, Sq != Sk)
GATE_ARCHS = ("qwen1.5-0.5b", "qwen3-14b", "internvl2-2b", "whisper-tiny")


def faulted_ops(fault: str):
    """A fresh ``ops`` module whose ``ref`` (or itself) carries ``fault``."""
    import types
    from pathlib import Path

    from repro_torch.kernels.flash_attention import ref as real_ref

    mods = {}
    for name, path in (("ref", real_ref.__file__), ("ops", fa.__file__)):
        src = Path(path).read_text()
        for where, old, new in FAULTS[fault]:
            if name == where:
                assert src.count(old) == (2 if fault == "gqa_sum_group_0_only" else 1), fault
                src = src.replace(old, new)
        mod = types.ModuleType(f"repro_torch.kernels.flash_attention.{name}_{fault}")
        mod.__package__ = "repro_torch.kernels.flash_attention"
        exec(compile(src, f"<{name}.py with {fault}>", "exec"), mod.__dict__)
        mods[name] = mod
    mods["ops"].ref = mods["ref"]
    return mods["ops"]


def attention_gate(ops, dt, margins=None) -> list[str]:
    """The host attention gate (out, lse and the Function's grads against
    the reference over FA_CASES); returns what failed. ``margins``, a dict,
    collects the largest rel / REL and worst elementwise ratio per tensor."""
    failed = []
    for case in FA_CASES:
        causal, kv_len = case[6], case[7]
        (q, k, v, g), _ = _operands(case, dt)
        want_out, want = _jax_vjp_case(case, dt)
        _, want_lse = fa.ref.attention_fwd_lse(q.float(), k.float(), v.float(),
                                               causal=causal, kv_len=kv_len)
        no_key = ~fa.ref.visible(case[3], case[4], causal=causal, kv_len=kv_len,
                                 device=q.device).any(-1)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=causal, kv_len=kv_len)
        out.backward(g)
        _, lse = ops.flash_attention_fwd_lse(q.float(), k.float(), v.float(), causal=causal,
                                             kv_len=kv_len)
        checks = [lambda: gates.check(out.detach(), _t(want_out), GATE[dt], "out"),
                  lambda: gates.check_lse(lse, want_lse, no_key, "lse")]
        checks += [lambda n=n, got=t.grad, w=w: gates.check(got, _t(w), GATE[dt], n)
                   for n, t, w in zip(("dq", "dk", "dv"), leaves, want)]
        if margins is not None:
            for n, got, w in zip(("out", "dq", "dk", "dv"), [out.detach()] +
                                 [t.grad for t in leaves], [want_out, *want]):
                m = gates.measure(got, _t(w), GATE[dt])
                rel, worst = margins.get(n, (0.0, 0.0))
                margins[n] = (max(rel, m["rel"] / gates.GATES[GATE[dt]][0]),
                              max(worst, m["worst"]))
        for check in checks:
            try:
                check()
            except AssertionError as e:
                failed.append(f"{case}: {e}")
    return failed


def model_gate(ops) -> list[str]:
    """The model_f32 gate through FlashAttention on the GATE_ARCHS."""
    failed = []
    for arch in GATE_ARCHS:
        _, _, cfg, params = jax_pair(arch)
        want_loss, want_grads = jax_loss_and_grads(arch, True)
        model = function_model(build_model(cfg, device="cpu"), ops.flash_attention)
        loss, _, grads = port_loss_and_grads(model, params, _batch(cfg), True)
        try:
            if not abs(loss.item() - want_loss) <= 1e-4 * abs(want_loss):
                raise AssertionError(f"loss {loss.item()} vs {want_loss}")
            check_model_grads(grads, want_grads)
        except AssertionError as e:
            failed.append(f"{arch}: {e}")
    return failed


def run_gate(gate: str, ops) -> list[str]:
    if gate == "model_f32":
        return model_gate(ops)
    return attention_gate(ops, {"host_f32": "float32", "host_bf16": "bfloat16"}[gate])


@pytest.mark.parametrize("gate", ["host_f32", "host_bf16", "model_f32"])
@pytest.mark.parametrize("fault", [f for f in FAULTS])
def test_gate_fails_on_planted_fault(fault, gate):
    """Every (fault, gate) pair outside BLIND fails; the pairs in BLIND are
    shown by ``python tests/test_torch_train.py`` and argued above."""
    if (fault, gate) in BLIND:
        assert not run_gate(gate, faulted_ops(fault)), "BLIND pair is caught: update BLIND"
    else:
        assert run_gate(gate, faulted_ops(fault)), f"{gate} passed {fault}"


# the card's check of the D-112 training kernels (chip_smoke.py phase 5a,
# tests/test_torch_cuda_kernels.py) holds each kernel to its plain version
# under card_bf16 / card_f32: with the fault on the kernel's side, both fail
D112_CASE = FA_CASES[-1]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_card_gates_fail_on_d112_tail_columns_dropped(dt):
    """dq and dk with the d112_tail_columns_dropped fault against the
    unfaulted plain versions on the same inputs fail the card gate of their
    dtype; the unfaulted pair passes it."""
    from repro_torch.kernels.flash_attention import ref as real_ref

    faulted = faulted_ops("d112_tail_columns_dropped").ref
    causal, kv_len = D112_CASE[6], D112_CASE[7]
    (q, k, v, g), _ = _operands(D112_CASE, dt)
    kw = dict(causal=causal, kv_len=kv_len)
    out, lse = real_ref.attention_fwd_lse(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    gate = {"float32": "card_f32", "bfloat16": "card_bf16"}[dt]
    want_dq = real_ref.attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    want_dk, _ = real_ref.attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    gates.check(real_ref.attention_bwd_dq(q, k, v, g, lse, delta, **kw), want_dq, gate, "dq")
    for name, got, want in (
            ("dq", faulted.attention_bwd_dq(q, k, v, g, lse, delta, **kw), want_dq),
            ("dk", faulted.attention_bwd_dkv(q, k, v, g, lse, delta, **kw)[0], want_dk)):
        assert not gates.measure(got, want, gate)["ok"], name


if __name__ == "__main__":
    for dt in ("float32", "bfloat16"):
        margins = {}
        assert not attention_gate(fa, dt, margins)
        print(f"unfaulted {GATE[dt]}: largest rel / REL and worst elementwise / limit "
              f"per tensor over FA_CASES: {margins}")
    for fault in FAULTS:
        for gate in ("host_f32", "host_bf16", "model_f32"):
            failed = run_gate(gate, faulted_ops(fault))
            print(f"{fault:40s} {gate:10s} {'CAUGHT' if failed else 'passed'} "
                  f"({len(failed)} checks failed){': ' + failed[0][:160] if failed else ''}")
