"""The port stands alone: no file of src/repro_torch/, no generated package
of its generator and not chip_smoke.py imports JAX or the JAX package
``repro`` (``repro_torch`` is its own); and its entry points run on the card
unless the caller asks for the CPU — asking for CUDA where there is none, or
on a card that is not Hopper, raises instead of quietly running elsewhere."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core import generate_all, load_corpus

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(source: str) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def _bad(mods: set[str]) -> set[str]:
    return {m for m in mods if m.split(".")[0] in FORBIDDEN}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_repro(path):
    assert not _bad(_imports(path.read_text())), path


def test_upd_bodies_and_generated_packages_import_neither():
    for prim in load_corpus().primitives.values():
        for d in prim.definitions:
            assert not _bad(_imports(d.helpers) | _imports(d.implementation)), prim.name
    for target, pkg in generate_all().items():
        for f in pkg.glob("*.py"):
            assert not _bad(_imports(f.read_text())), (target, f)


def test_serve_cli_without_device_cpu_raises_on_a_host_without_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "1"])


def test_non_hopper_card_raises_and_cpu_maps_to_torch_cpu(monkeypatch):
    from repro_torch.device import resolve_device, target_for

    assert target_for("cpu") == "torch_cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: (9, 0))
    assert target_for("cuda") == "h100"
