"""Training the vlm (internvl2) and audio (whisper) families against the JAX
reference on the host: ``Model.loss`` and every gradient leaf, three AdamW
steps of ``make_train_step``, the microbatch split of the embedding rows
and the compiled step with them in its staged batch.

Reduced configs from the reference's own params (``load_jax_params``):
internvl2-2b (2 layers, GQA 4/2, d 64) behind 8 vision rows, and
whisper-tiny (2 + 2 layers, d 64) over 24 encoder frames against 16 tokens,
so its cross-attention runs at Sq != Sk. Inputs are numpy draws from a seed
(``test_torch_train._batch``), float32.

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

from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.nn.model import EncDecModel, Model, build_model
from repro_torch.train import (OptConfig, compile_train_step, init_opt_state,
                               loss_and_grads, make_train_step)
from repro_torch.train.optimizer import tree_items, tree_map
from test_torch_train import (_batch, _rel, check_model_grads, function_model,
                              jax_loss_and_grads, jax_pair, port_loss_and_grads)

ARCHS = ("internvl2-2b", "whisper-tiny")
EMBEDS = {"internvl2-2b": "vision_embeds", "whisper-tiny": "audio_embeds"}
STEP_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=10)
# one of the two step comparisons splits its batch into 2 microbatches
STEP_MICROBATCHES = {"internvl2-2b": 2, "whisper-tiny": 1}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch):
    """(reference model, its params, port config, port params) and the
    reference's loss and grads with and without remat, run once a module."""
    pair = jax_pair(arch)
    return pair, {remat: jax_loss_and_grads(arch, remat) for remat in (True, False)}


@pytest.mark.parametrize("attention", ["torch_cpu", "flash_function"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(arch, reference, remat, attention):
    """The loss and every grad leaf (``vision_proj`` and the
    cross-attention's among them) against jax.value_and_grad(model.loss,
    has_aux=True), with and without remat; ``flash_function`` runs every
    attention through FlashAttention (the plain versions of the lse
    forward, dq and dk/dv: whisper's non-causal encoder and Sq != Sk
    cross-attention)."""
    (_, _, cfg, params), runs = reference
    want_loss, want_grads = runs[remat]
    model = build_model(cfg, device="cpu")
    assert type(model) is {"vlm": Model, "audio": EncDecModel}[cfg.family]
    if attention == "flash_function":
        model = function_model(model)
    loss, metrics, grads = port_loss_and_grads(model, params, _batch(cfg), remat)
    assert abs(loss.item() - want_loss) <= 1e-4 * abs(want_loss)
    assert metrics["aux"].item() == 0.0 and metrics["ce"].item() == loss.item()
    check_model_grads(grads, want_grads)
    assert len(jax.tree.leaves(want_grads)) == {"internvl2-2b": 13, "whisper-tiny": 32}[arch]


def test_train_step_matches_reference(arch, reference):
    """make_train_step for 3 steps from the reference's params on one seeded
    batch of 4 rows with its embedding rows (internvl2 in 2 microbatches):
    every step's loss, ce and grad_norm within 1e-4 relative of the
    reference's make_train_step, lr within 1e-6; the loss falls."""
    (jmodel, jparams, cfg, params), _ = reference
    k = STEP_MICROBATCHES[arch]
    jstep = jax.jit(jax_make_train_step(jmodel, jax_opt.OptConfig(**STEP_OPT),
                                        microbatches=k))
    tstep = make_train_step(build_model(cfg, device="cpu"), OptConfig(**STEP_OPT),
                            microbatches=k)
    batch = _batch(cfg, seed=5, b=4)
    assert EMBEDS[arch] in batch
    jstate = {"params": jparams,
              "opt": jax_opt.init_opt_state(jax_opt.OptConfig(**STEP_OPT), jparams)}
    tstate = {"params": params, "opt": init_opt_state(OptConfig(**STEP_OPT), params)}
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in batch.items()})
        tstate, tm = tstep(tstate, {n: torch.from_numpy(v) for n, v in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(tm[key].item(), jm[key]) <= 1e-4, (key, tm[key], jm[key])
        assert tm["aux"].item() == float(jm["aux"]) == 0.0
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        losses.append(tm["loss"].item())
    assert losses[2] < losses[0]


def test_microbatches_split_the_embedding_rows(arch, reference):
    """The microbatch split cuts every batch entry on its leading axis, the
    embedding rows with the tokens: 2 microbatches' loss is the mean of
    the two halves' losses and their grads the mean of the halves' grads
    (float32 sums in another order: rel 1e-6)."""
    (_, _, cfg, params), _ = reference
    model = build_model(cfg, device="cpu")
    batch = {n: torch.from_numpy(v) for n, v in _batch(cfg, seed=9, b=4).items()}
    step = make_train_step(model, OptConfig(**STEP_OPT), microbatches=2)
    loss, _, grads = step._grads(params, batch)
    halves = [loss_and_grads(model, params, {n: v[i * 2:(i + 1) * 2] for n, v in batch.items()})
              for i in range(2)]
    assert _rel(loss.item(), (halves[0][0].item() + halves[1][0].item()) / 2) <= 1e-6
    for (path, g), (_, a), (_, b) in zip(tree_items(grads), tree_items(halves[0][2]),
                                         tree_items(halves[1][2])):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), (a.double() + b.double()).numpy() / 2) <= 1e-6, path
    # a batch whose embedding rows do not split raises, naming them
    odd = {**batch, EMBEDS[arch]: batch[EMBEDS[arch]][:3]}
    with pytest.raises(ValueError, match=EMBEDS[arch]):
        step._grads(params, odd)


def test_compiled_step_with_embedding_rows_in_the_staged_batch(arch, reference):
    """compile_train_step over a batch with the embedding rows (four staged
    inputs with the schedule's scalars): three steps equal to
    the eager step's bit for bit (metrics every step, every leaf at the
    end), one compiled entry; a batch whose embedding rows have another
    shape or dtype, or that lacks them, is refused as not what the step
    was compiled for."""
    (_, _, cfg, params), _ = reference
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=4, total_steps=10)
    step = make_train_step(build_model(cfg, device="cpu"), opt_cfg)
    compiled = compile_train_step(step)

    def state():
        p = tree_map(torch.clone, params)
        return {"params": p, "opt": init_opt_state(opt_cfg, p)}

    c_state, e_state = state(), state()
    batches = [_batch(cfg, seed=30 + i, b=2) for i in range(3)]
    for batch in batches:
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
    name = EMBEDS[arch]
    assert set(compiled.step.specs) == {"tokens", "labels", name, "sched"}
    rows = batches[0][name]
    for bad in ({**batches[0], name: rows[:, :-1]},
                {**batches[0], name: rows.astype(np.float64)},
                {n: v for n, v in batches[0].items() if n != name}):
        with pytest.raises(ValueError, match="compiled for"):
            compiled(c_state, bad)


@pytest.mark.parametrize("cli_arch", ARCHS)
def test_train_cli_refuses_the_embedding_families(cli_arch, monkeypatch):
    """The train CLI refuses internvl2-2b and whisper-tiny before building
    anything: SyntheticTokens carries no vision or audio rows (the
    reference's CLI fails on both too)."""
    from repro_torch.launch import train as train_cli

    def no_build(*args, **kwargs):
        raise AssertionError("the CLI built a model before refusing")

    monkeypatch.setattr(train_cli, "build_model", no_build)
    with pytest.raises(ValueError, match=f"{EMBEDS[cli_arch]}.*SyntheticTokens carries no "
                                         f"vision or audio rows"):
        train_cli.main(["--arch", cli_arch, "--reduced", "--device", "cpu", "--steps", "1"])
