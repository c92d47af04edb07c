#!/usr/bin/env python3
"""What splitting P and dS costs the bf16 flash backward, and what it buys.

The kept kernels (src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu)
split P (for dV) and dS (for dK and dQ) into their bf16 rounding and the bf16
rounding of the remainder and run both against the same B fragments. The
variant built here rounds them once to bf16, the usual flash design: the
copy of the source drops the remainder products. A measurement, not a gate;
it needs an sm_90 card. From the repo root:

    PYTHONPATH=src python3 tools/flash_bwd_rounding.py

It prints, for each version, the device ms per call of dq and of dk/dv at
the train shape (8,16,512,64) and the GQA shape (2, 40 over 8, 512, 128),
causal bf16, timed as chip_smoke.py times the kernel rows (graph_ms) in the
order kept, variant, variant, kept; and the worst reading of the card_bf16
gate of dq, dk and dv against the plain versions (on the plain lse and
delta) on each training case of tests/test_torch_cuda_kernels.py, with that
file's draws. The last line is one JSON object with all of it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

# the products of P's and dS's remainders; without them both are rounded once
REMAINDER_PRODUCTS = ("mma_bf16(dq_acc[2 * d2], ds_lo, b0, b1);",
                      "mma_bf16(dq_acc[2 * d2 + 1], ds_lo, b2, b3);",
                      "mma_bf16(dv_acc[2 * d2], p_lo, b0, b1);",
                      "mma_bf16(dv_acc[2 * d2 + 1], p_lo, b2, b3);",
                      "mma_bf16(dk_acc[2 * d2], ds_lo, b0, b1);",
                      "mma_bf16(dk_acc[2 * d2 + 1], ds_lo, b2, b3);")
SHAPES = {  # name: (B, H, KH, S, D)
    "train (8,16,512,64)": (8, 16, 16, 512, 64),
    "GQA (2, 40 over 8, 512, 128)": (2, 40, 8, 512, 128),
}


def rounded_once_bwd():
    """The backward's (dq, dkv) C functions built from a copy of the source
    without the remainder products (build/flash_bwd_rounding/)."""
    from repro_torch.kernels.common import load_shared_library
    from repro_torch.kernels.flash_attention import kernel

    text = kernel.BWD_SOURCES[0].read_text()
    for line in REMAINDER_PRODUCTS:
        assert text.count(line) == 1, f"not once in {kernel.BWD_SOURCES[0].name}: {line}"
        text = text.replace(line, "")
    out = ROOT / "build" / "flash_bwd_rounding"
    out.mkdir(parents=True, exist_ok=True)
    for header in kernel.HEADERS:
        (out / header.name).write_text(header.read_text())
    src = out / kernel.BWD_SOURCES[0].name
    src.write_text(text)
    return kernel.bind_bwd(load_shared_library("flash_bwd_rounded_once", [src]))


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
    ref = fa.ref
    versions = {"kept (P, dS split)": kernel._bwd_fns(),
                "P, dS rounded once": rounded_once_bwd()}
    print(gpu_line(), flush=True)
    result = {"timing": DEVICE_TIMING, "ms": {v: {} for v in versions},
              "card_bf16_worst": {v: {} for v in versions}}

    def inputs(b, h, kh, sq, sk, d, causal, kv_len):
        rand = _draws(dev, torch.bfloat16)
        q, k, v, do = rand(b, h, sq, d), rand(b, kh, sk, d), rand(b, kh, sk, d), \
            rand(b, h, sq, d)
        kw = dict(causal=causal, kv_len=kv_len)
        out, lse = ref.attention_fwd_lse(q, k, v, **kw)
        return (q, k, v, do, lse, (do.float() * out.float()).sum(-1)), kw

    for name, (b, h, kh, s, d) in SHAPES.items():
        args, kw = inputs(b, h, kh, s, s, d, True, None)
        calls = {"dq": lambda: fa.flash_attention_bwd_dq(*args, **kw),
                 "dk/dv": lambda: fa.flash_attention_bwd_dkv(*args, **kw)}
        for version in (*versions, *reversed(versions)):
            kernel._bwd_fns = lambda fns=versions[version]: fns
            for kname, call in calls.items():
                result["ms"][version].setdefault(f"{kname} {name}", []).append(
                    graph_ms(call, 20))
        print(f"{name}: " + "; ".join(
            f"{v} {[result['ms'][v][f'{k} {name}'] for k in calls]}" for v in versions),
              flush=True)
        del args
    for version, fns in versions.items():
        kernel._bwd_fns = lambda fns=fns: fns
        for case in TRAIN_CASES:
            args, kw = inputs(*case)
            dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
            dk_r, dv_r = ref.attention_bwd_dkv(*args, **kw)
            got = {"dq": (fa.flash_attention_bwd_dq(*args, **kw),
                          ref.attention_bwd_dq(*args, **kw)),
                   "dk": (dk, dk_r), "dv": (dv, dv_r)}
            result["card_bf16_worst"][version][str(case)] = {
                n: gates.measure(a, w, "card_bf16")["worst"] for n, (a, w) in got.items()}
        worst = {c: [round(x, 3) for x in w.values()]
                 for c, w in result["card_bf16_worst"][version].items()}
        print(f"{version}: worst of the card_bf16 limit per case (dq, dk, dv) {worst}",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
