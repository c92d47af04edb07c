"""The port's compiled train step (``repro_torch/train/graphs.py``), the
counterpart of the reference's ``jax.jit(train_step, donate_argnums=(0,))``,
on reduced qwen1.5-0.5b.

On the host the compiled step runs its core eagerly against the static
buffers and the donated state a captured graph would hold, so these tests
exercise what the card's replays share with it: the staging of the batch
and of the schedule's scalars, the donation (the state updated in place),
the checks on what a call passes, and ``disable_graphs()``.

Tolerances: the compiled step against the eager port, bit for bit (the same
ops on the same values); against the reference's jitted, donated step the
ones of ``tests/test_torch_train.py::test_train_step_matches_reference``:
loss, ce and grad_norm rel <= 1e-4, lr rel <= 1e-6.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.graphs import disable_graphs
from repro_torch.launch import train as train_cli
from repro_torch.nn.model import build_model
from repro_torch.train import (OptConfig, compile_train_step, init_opt_state,
                               make_train_step)
from repro_torch.train.optimizer import tree_items, tree_map
from test_torch_train import _batch, _rel, jax_pair

ARCH = "qwen1.5-0.5b"
STEPS = 6
# warmup across the whole run, so lr and both bias corrections change every step
OPT = dict(lr=1e-3, warmup_steps=8, total_steps=12)
CASES = {
    "float32": ({}, {}),
    "int8": ({"moment_dtype": "int8"}, {}),
    "microbatches2": ({}, {"microbatches": 2}),
    "compress": ({}, {"compress_grads": True}),
}


def _state(params, opt_cfg):
    """A fresh train state whose params are copies of ``params``."""
    p = tree_map(torch.clone, params)
    return {"params": p, "opt": init_opt_state(opt_cfg, p)}


def _state_leaves(state):
    """(path, tensor) of a train state's params and moments, in one order."""
    return tree_items({"params": state["params"], "m": state["opt"]["m"],
                       "v": state["opt"]["v"]})


def _load(state, snapshot):
    """Copy ``snapshot``'s leaves and count into ``state``'s own tensors."""
    for (_, dst), (_, src) in zip(_state_leaves(state), _state_leaves(snapshot)):
        dst.copy_(src)
    state["opt"]["count"] = snapshot["opt"]["count"]


def _clone(state):
    return {"params": tree_map(torch.clone, state["params"]),
            "opt": {"m": tree_map(torch.clone, state["opt"]["m"]),
                    "v": tree_map(torch.clone, state["opt"]["v"]),
                    "count": state["opt"]["count"]}}


def _batches(cfg, n, b=4):
    return [_batch(cfg, seed=100 + i, b=b) for i in range(n)]


def _setup(case):
    _, _, cfg, params = jax_pair(ARCH)
    opt_kw, step_kw = CASES[case]
    opt_cfg = OptConfig(**OPT, **opt_kw)
    step = make_train_step(build_model(cfg, device="cpu"), opt_cfg, **step_kw)
    return cfg, params, opt_cfg, step


def _assert_states_equal(got, want):
    g, w = _state_leaves(got), _state_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert got["opt"]["count"] == want["opt"]["count"]


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_step_equals_the_eager_step_bit_for_bit(case):
    """Six steps on six batches through a warmup schedule, compiled (from
    one copy of the state) and eager (from another): every metric equal at
    every step, every param and moment leaf equal at the end."""
    cfg, params, opt_cfg, step = _setup(case)
    compiled = compile_train_step(step)
    c_state, e_state = _state(params, opt_cfg), _state(params, opt_cfg)
    lrs = []
    for batch in _batches(cfg, STEPS):
        c_state, cm = compiled(c_state, batch)
        e_state, em = step(e_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert list(cm) == list(em)
        for key in em:
            if key == "lr":
                assert isinstance(cm[key], float) and cm[key] == em[key]
            else:
                assert cm[key].shape == () and torch.equal(cm[key], em[key]), (key, cm[key],
                                                                               em[key])
        lrs.append(em["lr"])
    assert len(set(lrs)) == STEPS
    _assert_states_equal(c_state, e_state)
    assert compiled.entries == 1 and c_state["opt"]["count"] == STEPS


def test_compiled_step_holds_the_references_jitted_donated_step():
    """The reference's jax.jit(make_train_step(...), donate_argnums=(0,)) and
    the compiled port from the same params over the same six batches."""
    jmodel, jparams, cfg, params = jax_pair(ARCH)
    jcfg = jax_opt.OptConfig(**OPT)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg), donate_argnums=(0,))
    jstate = {"params": jax.tree.map(jnp.copy, jparams),
              "opt": jax_opt.init_opt_state(jcfg, jparams)}
    _, _, opt_cfg, step = _setup("float32")
    compiled = compile_train_step(step)
    state = _state(params, opt_cfg)
    for batch in _batches(cfg, STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm = compiled(state, batch)
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(tm[key].item(), jm[key]) <= 1e-4, (key, tm[key], jm[key])
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6


class _Writes(TorchDispatchMode):
    """Counts, per tensor storage, the ops that write into it in place."""

    def __init__(self, ptrs):
        super().__init__()
        self.ptrs, self.writes = ptrs, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        schema = func._schema
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write and i < len(args):
                t = args[i]
                if isinstance(t, torch.Tensor) and t.data_ptr() in self.ptrs:
                    key = (t.data_ptr(), func.overloadpacket.__name__)
                    self.writes[key] = self.writes.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def test_the_state_is_donated_and_updated_in_place():
    """The state the first call is given becomes the step's own: the
    returned state is that state, every leaf keeps its tensor and data_ptr
    from call to call, and in a call each param and moment tensor is
    written once (the update's own copy_), so nothing is copied in or out."""
    cfg, params, opt_cfg, step = _setup("int8")
    compiled = compile_train_step(step)
    state = _state(params, opt_cfg)
    leaves = _state_leaves(state)
    ptrs = {t.data_ptr(): path for path, t in leaves}
    assert len(ptrs) == len(leaves)
    batches = _batches(cfg, 3)
    out, _ = compiled(state, batches[0])
    for batch in batches[1:]:
        with _Writes(set(ptrs)) as mode:
            out, _ = compiled(out, batch)
        assert out is compiled.state
        assert [(p, t.data_ptr()) for p, t in _state_leaves(out)] == \
            [(p, t.data_ptr()) for p, t in leaves]
        assert all(a is b for (_, a), (_, b) in zip(_state_leaves(out), leaves))
        written = {}
        for (ptr, name), n in mode.writes.items():
            written.setdefault(ptrs[ptr], []).extend([name] * n)
        assert written == {path: ["copy_"] for path in ptrs.values()}, written
    assert out["opt"]["count"] == 3


def test_the_core_reads_the_schedule_only_from_its_staged_scalars():
    """From the same static inputs and state, the step's core gives the same
    update whatever the host count says; the scalars of another step give
    another update; and with the next step's scalars staged it equals the
    eager step."""
    cfg, params, opt_cfg, step = _setup("float32")
    batches = _batches(cfg, 2)
    compiled = compile_train_step(step)
    state, _ = compiled(_state(params, opt_cfg), batches[0])
    snapshot = _clone(state)
    sched = step.scalars(1)
    inputs = {**batches[1], "sched": sched}
    m1 = {k: v.clone() for k, v in compiled.step(**inputs).items()}
    after = _clone(compiled.state)
    _load(compiled.state, snapshot)
    compiled.state["opt"]["count"] += 7             # the host count advanced
    m2 = compiled.step(**inputs)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    _assert_states_equal({**compiled.state, "opt": {**compiled.state["opt"], "count": 1}},
                         after)
    _load(compiled.state, snapshot)
    compiled.step(**{**inputs, "sched": step.scalars(5)})
    assert not torch.equal(compiled.state["params"]["embed"], after["params"]["embed"])
    eager, em = step(_clone(snapshot), {k: torch.from_numpy(v)
                                        for k, v in batches[1].items()})
    _assert_states_equal({**after, "opt": {**after["opt"], "count": 2}}, eager)
    assert all(torch.equal(m1[k], em[k]) for k in m1)


def test_a_batch_of_another_shape_or_dtype_raises():
    cfg, params, opt_cfg, step = _setup("float32")
    compiled = compile_train_step(step)
    batch = _batches(cfg, 1)[0]
    state, _ = compiled(_state(params, opt_cfg), batch)
    with pytest.raises(ValueError, match="compiled for"):
        compiled(state, _batch(cfg, b=2))
    with pytest.raises(ValueError, match="compiled for"):
        compiled(state, {k: v.astype(np.int64) for k, v in batch.items()})
    with pytest.raises(ValueError, match="compiled for"):
        compiled(state, {"tokens": batch["tokens"]})
    assert state["opt"]["count"] == 1


def test_disable_graphs_runs_the_eager_step():
    """Under disable_graphs() the call is the functional eager step on the
    caller's state: a new state, the caller's untouched, nothing compiled."""
    cfg, params, opt_cfg, step = _setup("microbatches2")
    compiled = compile_train_step(step)
    batch = _batches(cfg, 1)[0]
    state = _state(params, opt_cfg)
    before = _clone(state)
    with disable_graphs():
        new, m = compiled(state, batch)
    assert compiled.step is None and compiled.entries == 0
    _assert_states_equal(state, before)
    want, wm = step(_clone(before), {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_states_equal(new, want)
    assert all(torch.equal(m[k], wm[k]) for k in wm if k != "lr") and m["lr"] == wm["lr"]


def test_a_state_the_step_does_not_own_is_refused():
    """After the first call the step takes only the state it returned: a
    clone of it, or a state the eager step made (a restored checkpoint, say),
    raises before anything runs, and the step's own state is untouched."""
    cfg, params, opt_cfg, step = _setup("float32")
    batches = _batches(cfg, 3)
    compiled = compile_train_step(step)
    own, _ = compiled(_state(params, opt_cfg), batches[0])
    before = _clone(own)
    other, _ = step(_state(params, opt_cfg), {k: torch.from_numpy(v)
                                              for k, v in batches[1].items()})
    for foreign in (_clone(own), other):
        with pytest.raises(ValueError, match="compile a fresh step"):
            compiled(foreign, batches[2])
    _assert_states_equal(own, before)
    got, _ = compiled(own, batches[1])
    want, _ = step(before, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    _assert_states_equal(got, want)


def test_the_compiled_step_is_freed_with_its_last_reference():
    """No reference cycle holds a compiled step (on the card: its graph and
    graph pool) once its caller drops it, without the cyclic collector."""
    cfg, params, opt_cfg, step = _setup("float32")
    compiled = compile_train_step(step)
    compiled(_state(params, opt_cfg), _batches(cfg, 1)[0])
    refs = weakref.ref(compiled), weakref.ref(compiled.step)
    gc.disable()
    try:
        del compiled
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
       "--log-every", "1"]


def test_a_restored_checkpoint_continues_the_uninterrupted_run(tmp_path, capsys):
    """The train CLI (compiled step, --device cpu): 6 steps with checkpoints
    every 3, a restart to 9 that restores step 6 into a fresh compiled step,
    and 9 uninterrupted steps: the restart's losses and its step_9 leaves
    equal the uninterrupted run's bit for bit."""
    flags = ["--microbatches", "2", "--moment-dtype", "int8"]
    run, whole = tmp_path / "run", tmp_path / "whole"
    train_cli.main(CLI + flags + ["--steps", "6", "--ckpt-dir", str(run),
                                  "--ckpt-every", "3"])
    capsys.readouterr()
    restarted = train_cli.main(CLI + flags + ["--steps", "9", "--ckpt-dir", str(run),
                                              "--ckpt-every", "3"])
    log = capsys.readouterr().out
    assert "restored checkpoint at step 6" in log
    uninterrupted = train_cli.main(CLI + flags + ["--steps", "9", "--ckpt-dir", str(whole),
                                                  "--ckpt-every", "3"])
    whole_log = capsys.readouterr().out
    lines = [ln for ln in log.splitlines() if ln.startswith("[train] step ")]
    assert lines and all(ln.split(" (")[0] in whole_log for ln in lines)
    assert restarted["final_loss"] == uninterrupted["final_loss"]
    for i in range(len(list((whole / "step_9").glob("leaf_*.npy")))):
        a = np.load(run / "step_9" / f"leaf_{i}.npy")
        b = np.load(whole / "step_9" / f"leaf_{i}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), i


def test_the_module_paths_of_the_graph_machinery():
    """The serving steps' names still import from repro_torch.serve, and
    are the shared machinery's."""
    from repro_torch import graphs
    from repro_torch.serve import StepGraphs, disable_graphs as serve_disable
    from repro_torch.serve import graphs as serve_graphs

    assert serve_disable is graphs.disable_graphs is disable_graphs
    assert serve_graphs.Step is graphs.Step
    assert serve_graphs.CudaGraphRunner is graphs.CudaGraphRunner
    assert StepGraphs("cpu").runner is None
