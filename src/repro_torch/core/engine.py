"""Jinja2 template engine environment (paper §3.2 ③).

Two-stage rendering (paper: "we split our generation GPO into two stages"):

* **stage 1** — every implementation body from the UPD is itself treated as a
  Jinja2 template and rendered against {sru, ctype, dtype helpers, primitive}.
  This is what lets a single definition cover all ctypes (paper's Neon
  ``hadd`` one-liner).
* **stage 2** — structural library templates (``templates/*.j2``) are rendered
  with the selected, stage-1-rendered implementations.
"""

from __future__ import annotations

import textwrap
from pathlib import Path
from typing import Any

import jinja2

TEMPLATE_DIR = Path(__file__).resolve().parent / "templates"

# dtype helper table exposed to stage-1 templates: ``{{ dtype.torch }}`` is
# the torch dtype expression a body can use for its specialization's ctype
_DTYPE_INFO = {
    "float32": {"torch": "torch.float32", "short": "f32", "bits": 32, "kind": "float"},
    "bfloat16": {"torch": "torch.bfloat16", "short": "bf16", "bits": 16, "kind": "float"},
    "float16": {"torch": "torch.float16", "short": "f16", "bits": 16, "kind": "float"},
    "int64": {"torch": "torch.int64", "short": "i64", "bits": 64, "kind": "int"},
    "int32": {"torch": "torch.int32", "short": "i32", "bits": 32, "kind": "int"},
    "int16": {"torch": "torch.int16", "short": "i16", "bits": 16, "kind": "int"},
    "int8": {"torch": "torch.int8", "short": "i8", "bits": 8, "kind": "int"},
    "uint32": {"torch": "torch.uint32", "short": "u32", "bits": 32, "kind": "uint"},
    "uint16": {"torch": "torch.uint16", "short": "u16", "bits": 16, "kind": "uint"},
    "uint8": {"torch": "torch.uint8", "short": "u8", "bits": 8, "kind": "uint"},
}


def dtype_info(ctype: str) -> dict[str, Any]:
    if ctype not in _DTYPE_INFO:
        raise KeyError(f"unknown ctype {ctype!r}; known: {sorted(_DTYPE_INFO)}")
    return dict(_DTYPE_INFO[ctype], name=ctype)


def _indent(text: str, n: int = 4, first: bool = False) -> str:
    pad = " " * n
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if i == 0 and not first:
            out.append(ln)
        else:
            out.append(pad + ln if ln.strip() else ln)
    return "\n".join(out)


def make_environment() -> jinja2.Environment:
    env = jinja2.Environment(
        loader=jinja2.FileSystemLoader(str(TEMPLATE_DIR)),
        undefined=jinja2.StrictUndefined,
        trim_blocks=True,
        lstrip_blocks=True,
        keep_trailing_newline=True,
    )
    env.filters["indent_body"] = lambda s, n=4, first=True: _indent(s, n, first)
    env.filters["dedent"] = textwrap.dedent
    env.globals["dtype_info"] = dtype_info
    env.globals["dtype_table"] = _DTYPE_INFO
    return env


_ENV: jinja2.Environment | None = None


def environment() -> jinja2.Environment:
    global _ENV
    if _ENV is None:
        _ENV = make_environment()
    return _ENV


def render_stage1(body: str, *, sru: dict, ctype: str, primitive: str,
                  params: tuple[str, ...]) -> str:
    """Render one implementation body against its target data (stage 1)."""
    tmpl = environment().from_string(body)
    return tmpl.render(
        sru=sru,
        ctype=ctype,
        dtype=dtype_info(ctype),
        primitive=primitive,
        params=params,
    ).rstrip("\n")


def render_template(name: str, **ctx: Any) -> str:
    return environment().get_template(name).render(**ctx)
