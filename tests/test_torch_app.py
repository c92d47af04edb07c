"""The paper's range-count app (Fig 8) on the port, end to end on the host
(mirrors tests/test_system.py): the generated torch_cpu library's fused,
popcount and composed counts equal the hand-written torch count and the
JAX package's cpu_xla count on the same data; the quickstart and the
generator CLI run as a user runs them (``--device cpu``, cross-generation
for h100)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tsl_api
from repro_torch.core import cli
from repro_torch.launch import quickstart

ROOT = Path(__file__).resolve().parents[1]


def _jax_composed(ops, data, lo, hi):
    """tests/test_system.py's composed app on the reference library."""
    lv = ops.set1(lo, data.shape, dtype=str(data.dtype))
    uv = ops.set1(hi, data.shape, dtype=str(data.dtype))
    cv = ops.between_inclusive(data, lv, uv)
    iv = ops.select(cv, ops.set1(1, data.shape, dtype="int32"),
                    ops.set1(0, data.shape, dtype="int32"))
    return ops.hadd(iv.reshape(-1))


@pytest.mark.parametrize("dtype,lo,hi", [("float32", 5.0, 15.0),
                                         ("float32", 25000.0, 75000.0),
                                         ("int32", 5, 15), ("int32", 25, 74)])
def test_four_ways_equal_each_other_and_cpu_xla(dtype, lo, hi, lib_cpu):
    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 100_000, 1 << 14).astype(np.float32) if dtype == "float32"
         else rng.integers(0, 100, 1 << 14).astype(np.int32))
    counts = quickstart.count_four_ways(tsl_api.ops("cpu"), torch.from_numpy(x), lo, hi)
    assert set(counts) == {"fused", "popcount", "composed", "handwritten"}
    jx = jnp.asarray(x)
    want = {int(lib_cpu.ops.range_count(jx, lo, hi)),
            int(lib_cpu.ops.range_count_popcnt(jx, lo, hi)),
            int(_jax_composed(lib_cpu.ops, jx, lo, hi))}
    assert len(want) == 1 and set(counts.values()) == want


def test_four_ways_disagreeing_raises():
    class Broken:
        def __getattr__(self, name):
            ops = tsl_api.ops("cpu")
            if name == "range_count":
                return lambda d, lo, hi: ops.range_count(d, lo, hi) + 1
            return getattr(ops, name)

    with pytest.raises(AssertionError, match="disagree"):
        quickstart.count_four_ways(Broken(), torch.arange(100, dtype=torch.int32), 5, 15)


def test_quickstart_main_on_the_host():
    result = quickstart.main(["--device", "cpu", "--n", "4096", "--dtype", "int32",
                              "--low", "25", "--high", "74"])
    assert result["target"] == "torch_cpu" and result["device"] == "cpu"
    assert len(set(result["counts"].values())) == 1
    assert result["provenance"]["range_count_popcnt"]["required_flags"] == ["torch", "popcnt"]
    assert result["provenance"]["to_integral"]["is_native"] is False


def test_quickstart_without_device_cpu_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--n", "64"])


def _run(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_quickstart_module_runs_with_device_cpu():
    proc = _run("repro_torch.launch.quickstart", "--device", "cpu", "--n", "20000")
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["target"] == "torch_cpu" and len(set(result["counts"].values())) == 1


def test_generator_cli_corpus_and_cross_generation(tmp_path, capsys):
    proc = _run("repro_torch.core", "corpus")
    assert proc.returncode == 0, proc.stderr[-2000:]
    info = json.loads(proc.stdout)
    assert info["targets"] == ["h100", "torch_cpu"] and info["primitives"] == 41
    build = str(tmp_path / "b")
    assert cli.main(["generate", "--targets", "h100", "--build-root", build]) == 0
    out = capsys.readouterr().out
    pkg = Path(out.split("h100: ", 1)[1].strip())
    assert (pkg / "tests" / "test_generated.py").is_file()
    assert 'device="cuda"' in (pkg / "ops_memory.py").read_text()
    assert cli.main(["generate", "--targets", "nope", "--build-root", build]) == 2
    assert cli.main(["generate", "--build-root", build]) == 2


def test_generator_cli_cache_maintenance(tmp_path, capsys):
    build = str(tmp_path / "b")
    assert cli.main(["generate", "--all", "--only", "hadd", "--build-root", build]) == 0
    capsys.readouterr()
    assert cli.main(["cache", "stats", "--build-root", build]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["packages"] == 2 and stats["bytes"] > 0
    assert cli.main(["cache", "gc", "--build-root", build]) == 2
    assert cli.main(["cache", "gc", "--max-age-days", "1", "--build-root", build]) == 0
    assert "removed 0" in capsys.readouterr().out
    assert cli.main(["cache", "clear", "--build-root", build]) == 0
    assert "removed 2" in capsys.readouterr().out
    assert cli.main(["cache", "stats", "--build-root", build]) == 0
    assert json.loads(capsys.readouterr().out)["packages"] == 0
