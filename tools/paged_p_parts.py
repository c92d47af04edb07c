#!/usr/bin/env python3
"""What carrying P in three bf16 parts costs the paged kernel, and what it buys.

The kept kernel (src/repro_torch/kernels/paged/csrc/paged_attention.cu)
splits P into three bf16 parts before P V: its rounding and the roundings of
what is left. The variant built here keeps two, as the flash forward does:
the copy of the source drops the third part's products. A measurement, not a
gate; it needs an sm_90 card. From the repo root:

    PYTHONPATH=src python3 tools/paged_p_parts.py

It prints, for each version, the device ms per call at chip_smoke.py's
phase-1 paged shapes in bf16 (serving, long context, batch-1 GQA), timed as
chip_smoke.py times its rows (graph_ms) in the order kept, variant, variant,
kept; the largest |kernel - plain| over those shapes as a share of
chip_smoke.py's bf16 tolerance; and chip_smoke.py phase 2's full-width fused
paged decode step (qwen1.5-0.5b, batch 8 at kv_len 257) against the plain
version: logits rel L2, the rows whose argmax differs and the plain logits'
gap there. The last line is one JSON object with all of it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

# the third part's products; without them P goes in as two parts
THIRD_PART = ("mma_bf16(acc[2 * d2], a_lo, b0, b1);",
              "mma_bf16(acc[2 * d2 + 1], a_lo, b2, b3);")


def two_part_fn():
    """The C function built from a copy of the source without the third
    part (build/paged_p_parts/)."""
    from repro_torch.kernels.common import load_shared_library
    from repro_torch.kernels.paged import kernel

    text = kernel.SOURCES[0].read_text()
    for line in THIRD_PART:
        assert text.count(line) == 1, f"not once in {kernel.SOURCES[0].name}: {line}"
        text = text.replace(line, "")
    out = ROOT / "build" / "paged_p_parts"
    out.mkdir(parents=True, exist_ok=True)
    src = out / kernel.SOURCES[0].name
    src.write_text(text)
    return kernel.bind(load_shared_library("paged_p_two_parts", [src], kernel.HEADERS))


def main() -> int:
    import torch

    import chip_smoke
    from paged_split_plan import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.device import is_hopper
    from repro_torch.kernels.paged import kernel, ops as pa
    from repro_torch.nn.model import build_model

    if not is_hopper():
        print("needs an sm_90 (Hopper) CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    fns = {"kept (three parts)": kernel._fn(), "two parts": two_part_fn()}
    order = ["kept (three parts)", "two parts", "two parts", "kept (three parts)"]
    result = {"gpu": gpu, "timing": chip_smoke.DEVICE_TIMING, "ms": {},
              "share_of_tolerance": {}, "fused_paged_step": {}}
    shapes = {}
    for name, (b, h, kh, d, page, sq, kv_lens, width) in SHAPES.items():
        shapes[name] = chip_smoke.paged_operands(dev, torch.bfloat16, b, h, kh, d, page, sq,
                                                 kv_lens, width)
    cfg = get_config(chip_smoke.ARCH)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    for i, version in enumerate(order):
        kernel._fn = lambda fn=fns[version]: fn
        for name, (q, k, v, tables, kv_len) in shapes.items():
            ms = chip_smoke.graph_ms(lambda: pa.paged_attention(q, k, v, tables, kv_len), 50)
            result["ms"].setdefault(name, {}).setdefault(version, []).append(ms)
            got = pa.paged_attention(q, k, v, tables, kv_len)
            want = pa.ref.paged_attention_ref(q, k, v, tables, kv_len)
            check = chip_smoke.check_case("paged", name, got, want, torch.bfloat16)
            result["share_of_tolerance"].setdefault(name, {})[version] = check["tolerance_used"]
            print(f"[parts] {version} {name}: {ms:.5f} ms, {check['tolerance_used']:.3f} of "
                  f"tolerance", flush=True)
        if i < 2:
            with torch.inference_mode():
                step = chip_smoke.paged_step_compare(dev, model, params)
            result["fused_paged_step"][version] = {
                k: step[k] for k in ("logits_rel_l2", "argmax_kernel", "argmax_plain", "gaps")}
            print(f"[parts] {version} fused paged step: {json.dumps(step)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
