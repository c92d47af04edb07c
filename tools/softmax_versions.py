#!/usr/bin/env python3
"""Device time of the softmax wrapper on every phase-1 softmax case, from a
chosen source tree, so that two versions of the kernel are timed by one
timer on one card.

Times ``repro_torch.kernels.softmax.ops.softmax`` on each input of
chip_smoke.softmax_specs (the vocabulary rows, batch 1, float16, rows and a
base off 16-byte alignment, narrow rows, a streaming row) by
chip_smoke.graph_ms (20 calls in a CUDA graph, 5 replays: the timer of
phase 1), after holding its output against the plain version with
chip_smoke.check_case. ``--src`` imports ``repro_torch`` from another
checkout's ``src/`` (the parent commit unpacked by ``git archive`` into an
ignored directory); run versions in turns (parent, change, change, parent)
in one call. A measurement, not a gate; it needs an sm_90 card. From the
repo root:

    PYTHONPATH=src python3 tools/softmax_versions.py [--src DIR] [--label NAME]

The last line is one JSON object: the card, the label, and per case its
shape, dtype, note, ms and max abs error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]

    import torch

    import chip_smoke
    from repro_torch.kernels.softmax import ops as sm

    if not torch.cuda.is_available():
        print("softmax_versions: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = chip_smoke.gpu_line()
    cases = []
    for x, _, note in chip_smoke.softmax_specs(dev):
        err = chip_smoke.check_case("softmax", list(x.shape), sm.softmax(x), sm.ref.softmax(x),
                                    x.dtype, nan_ok=True, atol_scale=1 / x.shape[-1])
        ms = chip_smoke.graph_ms(lambda: sm.softmax(x), 20)
        cases.append({"shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
                      "note": note, "ms": ms, "max_abs_err": err["max_abs_err"]})
        print(f"[{args.label}] {cases[-1]}", flush=True)
    print(gpu)
    print(json.dumps({"gpu": gpu, "label": args.label, "src": sm.__file__,
                      "timing": chip_smoke.DEVICE_TIMING, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
