#!/usr/bin/env python3
"""How the paged kernel's time depends on its split plan.

kernel.plan splits the keys of each (sequence, KV head) over blocks: enough
splits for about _BLOCKS_PER_SM (2) blocks per SM in all, but no more than
leave each split _MIN_SPLIT_KEYS (256) keys of a full table. This times the
kernel (src/repro_torch/kernels/paged/csrc/paged_attention.cu) at
chip_smoke.py's phase-1 paged shapes in bf16 (the serving decode step, a
long context, batch-1 GQA) under that plan and under others: one split
(the table in one block), one page per split, 1, 4 and 8 blocks per SM,
and 64, 128 and 512 keys per split at least; in the order plan, others,
plan. Each output is held against the plain version with chip_smoke.py's
tolerance. A measurement, not a gate; it needs an sm_90 card. From the repo
root:

    PYTHONPATH=src python3 tools/paged_split_plan.py

Device ms per call as chip_smoke.py times its rows (graph_ms). The last line
is one JSON object with all of it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

SHAPES = {  # name: (B, H, KH, D, page, SQ, kv_len per sequence, table width)
    "serving (8, 16/16, D 64, kv_len 260-316)":
        (8, 16, 16, 64, 64, 1, [260, 268, 276, 284, 292, 300, 308, 316], 5),
    "long context (8, 16/16, D 64, kv_len 3900-4096)":
        (8, 16, 16, 64, 64, 1, [3900, 3928, 3956, 3984, 4012, 4040, 4068, 4096], 64),
    "batch-1 GQA (1, 40/8, D 128, kv_len 4096)": (1, 40, 8, 128, 64, 1, [4096], 64),
}


def plans(b: int, kh: int, width: int, page: int, sms: int) -> dict[str, tuple[int, int]]:
    """(splits, pps) per plan name, kernel.plan's first and last."""
    from repro_torch.kernels.paged import kernel

    kept = kernel._BLOCKS_PER_SM, kernel._MIN_SPLIT_KEYS
    label = f"plan ({kept[0]} per SM, {kept[1]} keys)"
    out = {label: kernel.plan(b, kh, width, page, sms), "one split": (1, width),
           "one page per split": (width, 1)}
    try:
        for per_sm, keys in ((1, kept[1]), (4, kept[1]), (8, kept[1]), (kept[0], 64),
                             (kept[0], 128), (kept[0], 512)):
            kernel._BLOCKS_PER_SM, kernel._MIN_SPLIT_KEYS = per_sm, keys
            out[f"{per_sm} per SM, {keys} keys"] = kernel.plan(b, kh, width, page, sms)
    finally:
        kernel._BLOCKS_PER_SM, kernel._MIN_SPLIT_KEYS = kept
    out[label + ", again"] = out[label]
    return out


def main() -> int:
    import torch

    from chip_smoke import DEVICE_TIMING, check_case, gpu_line, graph_ms, paged_operands
    from repro_torch.device import is_hopper
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.paged import kernel, ref

    if not is_hopper():
        print("needs an sm_90 (Hopper) CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)
    result = {"gpu": gpu, "timing": DEVICE_TIMING, "ms": {}, "plans": {}}
    for name, (b, h, kh, d, page, sq, kv_lens, width) in SHAPES.items():
        q, k, v, tables, kv_len = paged_operands(dev, torch.bfloat16, b, h, kh, d, page, sq,
                                                 kv_lens, width)
        want = ref.paged_attention_ref(q, k, v, tables, kv_len)
        out = torch.empty_like(q)
        result["ms"][name], result["plans"][name] = {}, {}
        for label, (splits, pps) in plans(b, kh, width, page, sm_count(dev)).items():
            def call():
                kernel.paged_attention_4d(q, k, v, tables, kv_len, out, tile=64,
                                          scale=d ** -0.5, splits=splits, pps=pps)
            call()
            check_case(f"paged {label}", name, out, want, torch.bfloat16)
            result["ms"][name][label] = graph_ms(call, 50)
            result["plans"][name][label] = [splits, pps]
            print(f"[plan] {name} {label}: {splits} splits x {pps} pages, "
                  f"{result['ms'][name][label]:.5f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
