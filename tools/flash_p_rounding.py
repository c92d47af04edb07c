#!/usr/bin/env python3
"""What splitting P costs the bf16 flash forward, and what it buys.

The kept kernel (src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu)
splits P into its bf16 rounding and the bf16 rounding of the remainder and
runs both against the same V fragments. The variant built here rounds P once
to bf16, the usual flash design: the copy of the source drops the two
remainder products. A measurement, not a gate; it needs an sm_90 card. From
the repo root:

    PYTHONPATH=src python3 tools/flash_p_rounding.py

It prints, for each version, the device ms per call at the serving shape
(2,16,512,64), the lse shape (8,16,512,64) and the GQA shape (2, 40 over 8,
512, 128), all causal bf16, timed as chip_smoke.py times the flash rows
(graph_ms) in the order kept, variant, variant, kept; and the worst reading
of the card_bf16 gate of its lse forward against the plain version on each
training case of tests/test_torch_cuda_kernels.py, with that file's draws.
The last line is one JSON object with all of it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

# the two products of P's remainder; without them P is rounded once
REMAINDER_PRODUCTS = ("mma_bf16(acc[2 * d2], a_lo, b0, b1);",
                      "mma_bf16(acc[2 * d2 + 1], a_lo, b2, b3);")
SHAPES = {  # name: (B, H, KH, S, D, with lse)
    "serving (2,16,512,64)": (2, 16, 16, 512, 64, False),
    "lse (8,16,512,64)": (8, 16, 16, 512, 64, True),
    "lse GQA (2, 40 over 8, 512, 128)": (2, 40, 8, 512, 128, True),
}


def rounded_once_fwd():
    """The forward's C function built from a copy of the source without the
    remainder products (build/flash_p_rounding/)."""
    from repro_torch.kernels.common import load_shared_library
    from repro_torch.kernels.flash_attention import kernel

    text = kernel.SOURCES[0].read_text()
    for line in REMAINDER_PRODUCTS:
        assert text.count(line) == 1, f"not once in {kernel.SOURCES[0].name}: {line}"
        text = text.replace(line, "")
    out = ROOT / "build" / "flash_p_rounding"
    out.mkdir(parents=True, exist_ok=True)
    for header in kernel.HEADERS:
        (out / header.name).write_text(header.read_text())
    src = out / kernel.SOURCES[0].name
    src.write_text(text)
    return kernel.bind_fwd(load_shared_library("flash_p_rounded_once", [src]))


def main() -> int:
    import torch

    from chip_smoke import DEVICE_TIMING, gpu_line, graph_ms
    from repro_torch import gates
    from repro_torch.device import is_hopper
    from repro_torch.kernels.flash_attention import kernel, ops as fa
    from test_torch_cuda_kernels import TRAIN_CASES, _draws

    if not is_hopper():
        print("needs an sm_90 (Hopper) CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    versions = {"kept (P split)": kernel._fn(), "P rounded once": rounded_once_fwd()}
    print(gpu_line(), flush=True)
    result = {"timing": DEVICE_TIMING, "ms": {v: {} for v in versions},
              "card_bf16_worst": {v: {} for v in versions}}
    for name, (b, h, kh, s, d, lse) in SHAPES.items():
        rand = _draws(dev, torch.bfloat16)
        q, k, v = rand(b, h, s, d), rand(b, kh, s, d), rand(b, kh, s, d)
        call = ((lambda: fa.flash_attention_fwd_lse(q, k, v)) if lse
                else (lambda: fa.flash_attention(q, k, v)))
        for version in (*versions, *reversed(versions)):
            kernel._fn = lambda fn=versions[version]: fn
            result["ms"][version].setdefault(name, []).append(graph_ms(call, 20))
        print(f"{name}: " + "; ".join(f"{v} {result['ms'][v][name]}" for v in versions),
              flush=True)
    for version, fn in versions.items():
        kernel._fn = lambda fn=fn: fn
        for case in TRAIN_CASES:
            b, h, kh, sq, sk, d, causal, kv_len = case
            rand = _draws(dev, torch.bfloat16)
            q, k, v = rand(b, h, sq, d), rand(b, kh, sk, d), rand(b, kh, sk, d)
            kw = dict(causal=causal, kv_len=kv_len)
            out, _ = fa.flash_attention_fwd_lse(q, k, v, **kw)
            want, _ = fa.ref.attention_fwd_lse(q, k, v, **kw)
            worst = gates.measure(out, want, "card_bf16")["worst"]
            result["card_bf16_worst"][version][str(case)] = worst
        print(f"{version}: worst of the card_bf16 limit per case "
              f"{ {c: round(w, 3) for c, w in result['card_bf16_worst'][version].items()} }",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
