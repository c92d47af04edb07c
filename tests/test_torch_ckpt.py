"""The port's checkpointer (``repro_torch.ckpt``) and train CLI
(``repro_torch.launch.train``) on the host: the mechanics of
``tests/test_checkpoint.py`` (roundtrip, restore_latest, corruption,
async save, GC), and the reference's format in both directions. The
reference's ``Checkpointer`` writes and the port restores, and the port
writes and the reference restores: every leaf bit-equal, for float32 and
int8 moments, float32 and bfloat16 params. Then a run of the reference's
train CLI is continued by the port's CLI from the reference's checkpoint:
its losses agree with the reference's own continuation within 1e-4
relative (the two frameworks' float32 sums in another order, as in
``test_torch_train.py``).
"""

import json
import re
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as JaxCheckpointer
from repro.launch import train as jax_train
from repro.train import optimizer as jax_opt
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.launch import train as port_train
from repro_torch.nn.model import build_model, load_jax_params
from repro_torch.train import OptConfig, init_train_state
from repro_torch.train.optimizer import tree_map
from test_torch_train import jax_pair


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
        "nested": {"c": torch.from_numpy(rng.normal(size=(2, 2)).astype(np.float32)
                                         ).to(torch.bfloat16),
                   "b": torch.from_numpy(rng.integers(0, 5, (3,)).astype(np.int32))},
        "count": int(rng.integers(0, 100)),
    }


def _target():
    return tree_map(lambda x: x if isinstance(x, int) else torch.zeros_like(x), _tree())


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)          # the target's key order is kept
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, int):
        assert got == want
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(3, t, extra={"data": {"step": 3}}, async_=False)
    restored, extra = ck.restore(3, _target())
    assert extra == {"data": {"step": 3}}
    _assert_same(restored, t)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    # leaf i is the i-th of JAX's flatten order (keys sorted), not insertion order
    assert manifest["structure"] == ["a", "count", "nested/b", "nested/c"]
    assert manifest["dtypes"] == ["float32", "int32", "int32", "bfloat16"]
    assert manifest["shapes"] == [[8, 4], [], [3], [2, 2]]


def test_restore_latest_picks_highest_committed(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(1), async_=False)
    ck.save(5, _tree(5), async_=False)
    (tmp_path / "step_9").mkdir()                # a torn write (no manifest): ignored
    step, tree, _ = ck.restore_latest(_target())
    assert step == 5
    _assert_same(tree, _tree(5))
    assert Checkpointer(tmp_path / "empty").restore_latest(_target()) is None


def test_corruption_detected(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), async_=False)
    leaf = tmp_path / "step_1" / "leaf_0.npy"
    arr = np.load(leaf)
    flipped = arr.view(np.uint8).copy()
    flipped[0] ^= 0xFF
    np.save(leaf, flipped.view(arr.dtype).reshape(arr.shape))
    with pytest.raises(IOError, match="checksum"):
        ck.restore(1, _target())


def test_mismatched_target_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), async_=False)
    wrong_shape = _target()
    wrong_shape["a"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, wrong_shape)
    fewer = _target()
    del fewer["count"]
    with pytest.raises(ValueError, match="structure changed"):
        ck.restore(1, fewer)


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(2, t, async_=True)
    t["a"].add_(1.0)              # the host copy was taken on the caller's thread
    ck.wait()
    assert ck.completed_steps() == [2]
    _assert_same(ck.restore(2, _target())[0], _tree())


def test_failed_async_save_raises_at_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    (tmp_path / "file").write_text("")
    ck.dir = tmp_path / "file"                   # a save there cannot mkdir
    ck.save(2, _tree(), async_=True)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        ck.wait()
    ck.wait()                                    # reported once


def test_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), async_=False)
    assert ck.completed_steps() == [3, 4]


# -- the reference's format, both directions ---------------------------------

def _states(moment_dtype, dtype):
    """The reference's train state of reduced qwen1.5 (params in ``dtype``,
    seeded non-zero moments, count 7) as JAX arrays, and the port's state of
    the same values, built independently of any checkpoint code."""
    jmodel, jparams, cfg, _ = jax_pair("qwen1.5-0.5b")
    jparams = jax.tree.map(lambda p: p.astype(dtype), jparams)
    rng = np.random.default_rng(4)

    def moment(p):
        x = rng.normal(0, 1e-2, p.shape).astype(np.float32)
        return jax_opt._quantize(jnp.asarray(x)) if moment_dtype == "int8" else \
            jnp.asarray(x)

    jstate = {"params": jparams, "opt": {"m": jax.tree.map(moment, jparams),
                                         "v": jax.tree.map(moment, jparams),
                                         "count": jnp.asarray(7, jnp.int32)}}
    pcfg = cfg.replace(dtype=dtype)
    params = load_jax_params(jax.tree.map(np.asarray, jparams), pcfg, "cpu")

    def port_moment(tree):
        def conv(x):
            if isinstance(x, dict):
                return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
            return torch.from_numpy(np.array(x))
        return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(x, dict) and "q" in x)

    state = {"params": params, "opt": {"m": port_moment(jstate["opt"]["m"]),
                                       "v": port_moment(jstate["opt"]["v"]), "count": 7}}
    target = init_train_state(build_model(pcfg, device="cpu"),
                              OptConfig(moment_dtype=moment_dtype), seed=1)
    return jstate, state, target


def _bits(x):
    """A leaf's bytes and dtype name, for a bit-for-bit comparison."""
    if isinstance(x, int):
        return np.asarray(x, np.int32).tobytes(), "int32"
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.numpy().dtype)
    arr = np.asarray(x)
    return arr.tobytes(), str(arr.dtype)


def _assert_bit_equal(port_tree, jax_tree):
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_tree):
        node = port_tree
        for k in path:
            node = node[k.key]
        assert _bits(node) == _bits(leaf), jax.tree_util.keystr(path)
        n += 1
    assert n == len(jax.tree.leaves(jax_tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_port_restores_the_references_checkpoint(tmp_path, moment_dtype, dtype):
    jstate, _, target = _states(moment_dtype, dtype)
    JaxCheckpointer(tmp_path).save(7, jstate, extra={"data": {"step": 7}}, async_=False)
    step, restored, extra = Checkpointer(tmp_path).restore_latest(target)
    assert (step, extra) == (7, {"data": {"step": 7}})
    assert isinstance(restored["opt"]["count"], int)
    _assert_bit_equal(restored, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_reference_restores_the_ports_checkpoint(tmp_path, moment_dtype, dtype):
    jstate, state, _ = _states(moment_dtype, dtype)
    ck = Checkpointer(tmp_path)
    ck.save(7, state, extra={"data": {"step": 7}}, async_=True)
    ck.wait()
    step, restored, extra = JaxCheckpointer(tmp_path).restore_latest(
        jax.eval_shape(lambda: jstate))
    assert (step, extra) == (7, {"data": {"step": 7}})
    if dtype == "bfloat16":
        assert restored["params"]["embed"].dtype == ml_dtypes.bfloat16
    _assert_bit_equal(state, restored)
    _assert_bit_equal(state, jstate)


# -- the train CLI across frameworks -----------------------------------------

CLI = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2", "--seq", "16",
       "--ckpt-every", "2", "--log-every", "1"]
LOSS_LINE = re.compile(r"^\[train\] step (\d+) loss=([0-9.]+)", re.MULTILINE)


def _losses(text: str) -> dict:
    return {int(s): float(v) for s, v in LOSS_LINE.findall(text)}


@pytest.mark.parametrize("flags", [["--microbatches", "2", "--moment-dtype", "int8"],
                                   ["--compress-grads"]], ids=" ".join)
def test_port_cli_continues_the_references_run(tmp_path, capsys, flags):
    """The reference's CLI writes step_4; in one copy of the directory the
    reference continues to step 6, in the other the port does (--device
    cpu). Steps 5-6 (0-based 4, 5) agree within 1e-4 relative, and each
    side's step_6 restores in the other framework. With float32 moments
    their params also agree within 1e-4 relative L2 per leaf; with int8
    moments they are not compared, because a v whose q differs by one near
    0 moves that element's update by up to lr."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jax_train.main(CLI + flags + ["--steps", "4", "--ckpt-dir", str(ref_dir)])
    assert json.loads((ref_dir / "step_4" / "manifest.json").read_text()
                      )["extra"]["data"]["step"] == 4
    shutil.copytree(ref_dir, port_dir)
    capsys.readouterr()
    want = jax_train.main(CLI + flags + ["--steps", "6", "--ckpt-dir", str(ref_dir)])
    ref_log = capsys.readouterr().out
    got = port_train.main(CLI + flags + ["--steps", "6", "--ckpt-dir", str(port_dir),
                                         "--device", "cpu"])
    port_log = capsys.readouterr().out
    assert "restored checkpoint at step 4" in ref_log
    assert "restored checkpoint at step 4" in port_log
    ref_losses, port_losses = _losses(ref_log), _losses(port_log)
    assert sorted(ref_losses) == sorted(port_losses) == [4, 5]
    for s in (4, 5):            # printed to 4 decimals: each within 5e-5 of its loss
        assert abs(port_losses[s] - ref_losses[s]) <= 1e-4 * ref_losses[s] + 1e-4, s
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-4 * abs(want["final_loss"])
    assert set(want) <= set(got) and got["steps"] == want["steps"] == 6
    manifest = json.loads((port_dir / "step_6" / "manifest.json").read_text())
    assert manifest["extra"]["data"]["step"] == 6
    # the port's step_6 restores in the reference and the reference's in the port
    jmodel, jparams, cfg, _ = jax_pair("qwen1.5-0.5b")
    moment_dtype = "int8" if "int8" in flags else "float32"
    jcfg = jax_opt.OptConfig(moment_dtype=moment_dtype)
    shape = jax.eval_shape(lambda: {"params": jparams,
                                    "opt": jax_opt.init_opt_state(jcfg, jparams)})
    _, from_port, _ = JaxCheckpointer(port_dir).restore_latest(shape)
    target = init_train_state(build_model(cfg, device="cpu"),
                              OptConfig(moment_dtype=moment_dtype))
    _, from_ref, _ = Checkpointer(ref_dir).restore_latest(target)
    assert from_port["opt"]["count"] == from_ref["opt"]["count"] == 6
    if moment_dtype == "int8":
        return
    for path, leaf in jax.tree_util.tree_leaves_with_path(from_port["params"]):
        node = from_ref["params"]
        for k in path:
            node = node[k.key]
        w = np.asarray(leaf, np.float64)
        assert np.linalg.norm(node.numpy() - w) <= 1e-4 * np.linalg.norm(w), path
