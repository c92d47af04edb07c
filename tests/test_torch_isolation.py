"""The port stands alone: no file of src/repro_torch/, no Python carried in
its UPD YAML (``helpers:``, ``implementation:``, bench ``setup:`` blocks) or
its generator templates, no generated package and not chip_smoke.py imports
JAX or the JAX package ``repro`` (``repro_torch`` is its own), and no file of
the port imports ``ml_dtypes``, which the card's machine lacks; and its entry
points run on the card unless the caller asks for the CPU — asking for CUDA
where there is none, or on a card that is not Hopper, raises instead of
quietly running elsewhere."""

import ast
import re
from pathlib import Path

import pytest
import torch
import yaml

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


def test_no_port_file_imports_ml_dtypes():
    """The card's machine has no ml_dtypes: the checkpointer stores bfloat16
    through torch, never through it."""
    users = [str(p.relative_to(ROOT)) for p in _port_files()
             if any(m.split(".")[0] == "ml_dtypes" for m in _imports(p.read_text()))]
    assert not users


# import statements in code that is not plain Python yet (Jinja templates,
# code blocks of the UPD YAML before stage-1 rendering): scanned line by line
_IMPORT_LINE = re.compile(r"^\s*(?:from\s+([\w.]+)\s+import\b|import\s+([\w.,\s]+))",
                          re.MULTILINE)


def _line_imports(code: str) -> set[str]:
    mods = set()
    for frm, imp in _IMPORT_LINE.findall(code):
        if frm:
            mods.add(frm)
        else:
            mods |= {m.strip().split()[0] for m in imp.split(",") if m.strip()}
    return mods


def _code_blocks(node):
    """Every helpers / implementation / setup string of a UPD document."""
    if isinstance(node, dict):
        for key, val in node.items():
            if key in ("helpers", "implementation", "setup") and isinstance(val, str):
                yield val
            else:
                yield from _code_blocks(val)
    elif isinstance(node, list):
        for item in node:
            yield from _code_blocks(item)


def _upd_and_template_files():
    port = ROOT / "src" / "repro_torch"
    files = sorted((port / "tsl_data").rglob("*.yaml")) \
        + sorted((port / "core" / "templates").glob("*.j2"))
    assert len(files) >= 8
    return files


@pytest.mark.parametrize("path", _upd_and_template_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_upd_code_blocks_and_templates_import_neither_jax_nor_repro(path):
    text = path.read_text()
    if path.suffix == ".yaml":
        code = "\n".join(c for doc in yaml.safe_load_all(text) for c in _code_blocks(doc))
    else:
        code = text
    assert not _bad(_line_imports(code)), path


def test_code_block_scan_catches_a_copied_reference_import():
    doc = yaml.safe_load("definitions:\n  - helpers: |\n      from repro.kernels.paged.ref"
                         " import page_read as _r\n    implementation: |\n"
                         "      import jax.numpy as jnp, torch\n      return _r(x)\n")
    code = "\n".join(_code_blocks(doc))
    assert _bad(_line_imports(code)) == {"repro.kernels.paged.ref", "jax.numpy"}
    assert not _bad(_line_imports("from repro_torch.kernels.paged.ref import page_read"))


def test_upd_bodies_and_generated_packages_import_neither():
    for prim in load_corpus().primitives.values():
        for d in prim.definitions:
            assert not _bad(_imports(d.helpers) | _imports(d.implementation)), prim.name
    for target, pkg in generate_all().items():
        for f in pkg.rglob("*.py"):
            assert not _bad(_imports(f.read_text())), (target, f)


def test_serve_cli_without_device_cpu_raises_on_a_host_without_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "1"])


def test_train_cli_without_device_cpu_raises_on_a_host_without_cuda(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])


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
