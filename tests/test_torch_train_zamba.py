"""Training the hybrid family (zamba2: a Mamba2 backbone with one shared
attention block) against the JAX reference on the host: ``Model.loss`` and
every gradient leaf, three AdamW steps of ``make_train_step``, the compiled
step and the train CLI.

Reduced zamba2-7b from the reference's own params (``load_jax_params``):
4 layers in 2 groups of 2 (each group followed by the shared block), and
the same with ``n_layers=5``, which adds a remainder layer; d 64, 16 SSD
heads of 8, N 16, 4 attention heads of 16. Inputs are numpy draws from a
seed (``test_torch_train._batch``), float32.

Tolerances are ``tests/test_torch_train.py``'s: the loss within 1e-4
relative, every grad leaf under model_f32 (``check_model_grads``), the
train steps' loss, ce and grad_norm within 1e-4 relative and lr within
1e-6; the compiled step against the eager step bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn.model import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.nn.model import ZambaModel, build_model, load_jax_params
from repro_torch.train import (OptConfig, compile_train_step, init_opt_state,
                               make_train_step)
from repro_torch.train.optimizer import tree_items, tree_map
from test_torch_train import _batch, _rel, check_model_grads, port_loss_and_grads

ARCH = "zamba2-7b"
VARIANTS = {"groups": {}, "rest": {"n_layers": 5}}
STEP_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=10)
# one of the two step comparisons splits its batch into 2 microbatches
STEP_MICROBATCHES = {"groups": 1, "rest": 2}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    return request.param


@pytest.fixture(scope="module")
def reference(variant):
    """(reference model, its params, port config, port params) and the
    reference's loss and grads with and without remat, run once a module."""
    change = VARIANTS[variant]
    jcfg = jax_get_config(ARCH).reduced().replace(**change)
    cfg = get_config(ARCH).reduced().replace(**change)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    runs = {}
    for remat in (True, False):
        (loss, _), grads = jax.value_and_grad(
            lambda p, remat=remat: jmodel.loss(p, batch, remat=remat), has_aux=True)(jparams)
        runs[remat] = (float(loss), grads)
    return (jmodel, jparams, cfg, params), runs


@pytest.mark.parametrize("library", ["torch_cpu", "h100"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(variant, reference, remat, library):
    """The loss and every grad leaf (the shared block's, summed over its
    applications, the remainder stack's where there is one, the float32
    A_log / dt_bias / D_skip) against jax.value_and_grad(model.loss,
    has_aux=True), with and without remat: through the torch_cpu library
    (autograd through the plain attention and the time-step SSD scan) and
    through the h100 library on the host, the card's path: the shared block
    through FlashAttention (the plain versions of the lse forward, dq and
    dk/dv) and the chunked SSD (chunk 64) in every layer."""
    (_, _, cfg, params), runs = reference
    want_loss, want_grads = runs[remat]
    model = build_model(cfg, device="cpu", target=library)
    assert type(model) is ZambaModel and model.lib.TARGET_NAME == library
    loss, metrics, grads = port_loss_and_grads(model, params, _batch(cfg), remat)
    assert abs(loss.item() - want_loss) <= 1e-4 * abs(want_loss)
    assert metrics["aux"].item() == 0.0 and metrics["ce"].item() == loss.item()
    check_model_grads(grads, want_grads)
    assert len(jax.tree.leaves(want_grads)) == {"groups": 16, "rest": 24}[variant]


def _port_state(jstate, cfg):
    """The reference's train state (params, AdamW moments, count) as the
    port's, leaf for leaf."""
    opt = jstate["opt"]
    return {"params": load_jax_params(jax.tree.map(np.asarray, jstate["params"]), cfg, "cpu"),
            "opt": {"m": load_jax_params(jax.tree.map(np.asarray, opt["m"]), cfg, "cpu"),
                    "v": load_jax_params(jax.tree.map(np.asarray, opt["v"]), cfg, "cpu"),
                    "count": int(opt["count"])}}


def test_train_step_matches_reference(variant, reference):
    """make_train_step for 3 steps on one seeded batch of 4 rows (the
    remainder variant in 2 microbatches), each from the reference's state
    after as many steps: every step's loss, ce and grad_norm within 1e-4
    relative of the reference's make_train_step, lr within 1e-6, the new
    moments within 1e-4 relative L2 per leaf; the loss falls. Each step
    starts from the reference's state, not the port's own: AdamW's
    normalization amplifies float32 rounding in zamba's seeded reduced
    model (a parameter whose gradient is near eps moves by up to 0.13 lr on
    a 1e-6 difference of it; the zero-initialised dt_bias after one step is
    0.6 % apart, and the next step's grad_norm 0.3 %), so neither a
    trajectory nor the new params would compare the step."""
    (jmodel, jparams, cfg, _), _ = reference
    k = STEP_MICROBATCHES[variant]
    jstep = jax.jit(jax_make_train_step(jmodel, jax_opt.OptConfig(**STEP_OPT),
                                        microbatches=k))
    tstep = make_train_step(build_model(cfg, device="cpu"), OptConfig(**STEP_OPT),
                            microbatches=k)
    batch = _batch(cfg, seed=5, b=4)
    jstate = {"params": jparams,
              "opt": jax_opt.init_opt_state(jax_opt.OptConfig(**STEP_OPT), jparams)}
    losses = []
    for i in range(3):
        tstate = _port_state(jstate, cfg)
        assert tstate["opt"]["count"] == i
        jstate, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in batch.items()})
        tstate, tm = tstep(tstate, {n: torch.from_numpy(v) for n, v in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(tm[key].item(), jm[key]) <= 1e-4, (i, key, tm[key], jm[key])
        assert tm["aux"].item() == float(jm["aux"]) == 0.0
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        want = _port_state(jstate, cfg)["opt"]
        for tree in ("m", "v"):
            for (path, a), (_, b) in zip(tree_items(tstate["opt"][tree]),
                                         tree_items(want[tree])):
                assert _rel(a.numpy(), b.numpy()) <= 1e-4, (i, tree, path)
        losses.append(tm["loss"].item())
    assert losses[2] < losses[0]


def test_compiled_step_matches_eager_bit_for_bit():
    """compile_train_step over zamba's step (the remainder variant, every
    kind of block, through the h100 library on the host: FlashAttention and
    the chunked SSD, the card's path): three steps equal to the eager step's
    bit for bit (metrics every step, every leaf at the end), one compiled
    entry."""
    cfg = get_config(ARCH).reduced().replace(**VARIANTS["rest"])
    model = build_model(cfg, device="cpu", target="h100")
    params = model.init(3)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=4, total_steps=10)
    step = make_train_step(model, opt_cfg)
    compiled = compile_train_step(step)

    def state():
        p = tree_map(torch.clone, params)
        return {"params": p, "opt": init_opt_state(opt_cfg, p)}

    c_state, e_state = state(), state()
    for i in range(3):
        batch = _batch(cfg, seed=30 + i, b=2)
        c_state, cm = compiled(c_state, batch)
        e_state, em = step(e_state, {n: torch.from_numpy(v) for n, v in batch.items()})
        assert list(cm) == list(em)
        for key in em:
            assert (cm[key] == em[key]) if key == "lr" else torch.equal(cm[key], em[key]), key
    leaves = lambda s: tree_items({"params": s["params"], **{k: s["opt"][k]  # noqa: E731
                                                             for k in ("m", "v")}})
    for (path, a), (_, b) in zip(leaves(c_state), leaves(e_state)):
        assert torch.equal(a, b), path
    assert compiled.entries == 1 and c_state["opt"]["count"] == 3


def test_train_cli_trains_zamba():
    """The train CLI takes --arch zamba2-7b (SyntheticTokens' tokens and
    labels are all a zamba batch needs, as in the reference): 3 steps on
    the host through the compiled step, finite losses."""
    from repro_torch.launch import train as train_cli

    result = train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
                             "--batch", "2", "--seq", "16", "--log-every", "1"])
    assert result["arch"] == f"{ARCH}-reduced" and result["steps"] == 3
    assert np.isfinite(result["first_loss"]) and np.isfinite(result["final_loss"])
    assert result["final_loss"] != result["first_loss"]
