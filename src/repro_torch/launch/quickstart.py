"""Quickstart: generate the library for the device, print its selection
provenance, and run the paper's range-count app (Fig 8) through it four
ways — the fused ``range_count`` primitive, the ``range_count_popcnt``
flavour, the app composed from ``set1`` / ``between_inclusive`` / ``select``
/ ``hadd`` (Fig 8b), and a hand-written torch expression that uses no
library at all. All four counts must be equal. Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart --dtype int32 --low 25 --high 74
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import tsl_api
from repro_torch.device import resolve_device

# the paper's data (bench_fig10_applicability): uniform floats in
# [0, 100000); the int32 variant draws from [0, 100)
DATA_HIGH = {"float32": 100_000, "int32": 100}
PROVENANCE = ("range_count", "range_count_popcnt", "hadd", "to_integral", "softmax")


def make_data(n: int, dtype: str, device, seed: int = 0) -> torch.Tensor:
    """n seeded uniforms on ``device``, made there (no host copy)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == "float32":
        return torch.rand(n, generator=g, device=device).mul_(DATA_HIGH[dtype])
    return torch.randint(0, DATA_HIGH[dtype], (n,), generator=g, device=device,
                         dtype=torch.int32)


def handwritten(data: torch.Tensor, lo, hi) -> torch.Tensor:
    """The hand-written side of Fig 8: plain torch, no library."""
    return ((data >= lo) & (data <= hi)).sum(dtype=torch.int32)


def composed(ops, data: torch.Tensor, lo, hi) -> torch.Tensor:
    """Fig 8b: the same algorithm composed from library primitives."""
    lv = ops.set1(lo, data.shape, dtype=data.dtype)
    uv = ops.set1(hi, data.shape, dtype=data.dtype)
    cv = ops.between_inclusive(data, lv, uv)
    iv = ops.select(cv, ops.set1(1, data.shape, dtype="int32"),
                    ops.set1(0, data.shape, dtype="int32"))
    return ops.hadd(iv.reshape(-1))


def routes(ops) -> dict:
    """The app's four ways, each ``(data, lo, hi) -> 0-d int32 count``."""
    return {"fused": ops.range_count,
            "popcount": ops.range_count_popcnt,
            "composed": lambda data, lo, hi: composed(ops, data, lo, hi),
            "handwritten": handwritten}


def count_four_ways(ops, data: torch.Tensor, lo, hi) -> dict[str, int]:
    """The four counts; raises unless they are equal."""
    counts = {name: int(fn(data, lo, hi)) for name, fn in routes(ops).items()}
    if len(set(counts.values())) != 1:
        raise AssertionError(f"range count [{lo}, {hi}]: the four ways disagree: {counts}")
    return counts


def provenance(lib) -> dict:
    """Selection provenance of the app's primitives, from _manifest.json."""
    man = json.loads((Path(lib.__file__).parent / "_manifest.json").read_text())
    out = {}
    for prim in PROVENANCE:
        sels = man["primitives"][prim]
        ctype = "float32" if "float32" in sels else sorted(sels)[0]
        out[prim] = {k: sels[ctype][k] for k in ("score", "candidates", "is_native",
                                                  "required_flags")}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (a Hopper card, the default) or cpu")
    ap.add_argument("--n", type=int, default=1 << 20, help="data elements")
    ap.add_argument("--dtype", choices=sorted(DATA_HIGH), default="float32")
    ap.add_argument("--low", type=float, default=5)
    ap.add_argument("--high", type=float, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    lib = tsl_api.lib(dev)
    print(f"generated library: {lib.__name__}")
    print(f"target: {lib.TARGET_NAME}, {len(lib.PRIMITIVES)} primitives")
    prov = provenance(lib)
    for prim, sel in prov.items():
        print(f"  {prim:18s} score={sel['score']} candidates={sel['candidates']} "
              f"native={sel['is_native']} flags={sel['required_flags']}")

    # integer data takes integer bounds (a float bound would compare in
    # float32, and set1 would truncate it in the composed way)
    cast = int if args.dtype == "int32" else float
    lo, hi = cast(args.low), cast(args.high)
    data = make_data(args.n, args.dtype, dev, args.seed)
    counts = count_four_ways(lib.ops, data, lo, hi)
    expect = args.n * (hi - lo + (args.dtype == "int32")) / DATA_HIGH[args.dtype]
    print(f"range_count([{lo}, {hi}]) over {args.n} {args.dtype} uniforms on {dev}: "
          f"{counts} (expect ~{expect:.0f})")
    result = {"target": lib.TARGET_NAME, "device": str(dev), "n": args.n,
              "dtype": args.dtype, "low": lo, "high": hi, "counts": counts,
              "provenance": prov}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
