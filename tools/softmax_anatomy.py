#!/usr/bin/env python3
"""Where the wide softmax kernel's time goes: the kernel cut short stage by
stage.

Builds copies of src/repro_torch/kernels/softmax/csrc/softmax.cu whose
softmax_cluster_kernel returns (1) at once (the cluster launch alone), (2)
once its chunk is in shared memory, (3) once the CTA's (m, l) is published,
(4) once the row's (M, L) is read through the cluster (the second cluster
barrier kept), and times each beside the whole kernel at the vocabulary row
((8, 152064) and (1, 152064) bf16, (8, 152064) f32), at clusters of 16 and
8, by chip_smoke.graph_ms (20 calls in a CUDA graph, 5 replays: the timer of
phase 1); beside them a one-warp narrow launch ((2, 1) f32), the floor of
any launch. The cut copies' outputs are wrong by design; the whole kernel's
is held against the plain version.

Then copies of the whole kernel with one design choice changed (VARIANTS:
512 or 1024 threads per CTA against 256; exp2 by ex2.approx.ftz; the
second cluster barrier's arrive relaxed, without release semantics) are
timed the same way, at a cluster of 16, each held against the plain
version.

Last, a copy of the whole kernel whose thread 0 of each CTA stamps the SM's
cycle counter (clock64) and the global timer (%globaltimer, ns) at each
stage boundary (STAMPS) into shared memory, and copies them out only after
the last one (a global store before a cluster barrier's release would make
the barrier wait for it), gives, for one call at each shape, every stage's
cycles per CTA (median and largest over the CTAs), the spread of the CTAs'
start and end times and the whole call's span, and the SM clock they imply.
A measurement, not a gate; it needs an sm_90 card. From the repo root:

    PYTHONPATH=src python3 tools/softmax_anatomy.py

The last line is one JSON object with all of it.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# stage: (a line of softmax_cluster_kernel, the same line with the kernel's
# return put after it)
CUTS = {
    "launch only": ("  cg::cluster_group cluster = cg::this_cluster();",
                    "  return;\n  cg::cluster_group cluster = cg::this_cluster();"),
    "+ chunk in shared memory": ("      mbar_wait(b, 0);",
                                 "      mbar_wait(b, 0);\n      return;"),
    "+ the CTA's (m, l)": ("  cluster.sync();                       // every CTA's part",
                           "  return;\n  cluster.sync();                       // every CTA's part"),
    "+ the row's (M, L)": ("  cluster_arrive();                     // done with",
                           "  cluster_arrive();\n  cluster_wait();\n  return;\n"
                           "  cluster_arrive();                     // done with"),
}
SHAPES = (((8, 152064), "bfloat16"), ((1, 152064), "bfloat16"), ((8, 152064), "float32"))
# variant: (text of softmax.cu, its replacement); every occurrence is replaced
VARIANTS = {
    "512 threads per CTA": ("constexpr int CT = 256;", "constexpr int CT = 512;"),
    "1024 threads per CTA": ("constexpr int CT = 256;", "constexpr int CT = 1024;"),
    "exp2 by ex2.approx.ftz": ("exp2f(", "ex2_ftz("),
    # measured only: a relaxed arrive does not order the merge's remote loads
    # before it, so the PTX memory model does not promise it is safe
    "second arrive relaxed": ("barrier.cluster.arrive;", "barrier.cluster.arrive.relaxed;"),
}
EX2_FTZ = """
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
"""

# stamp k is taken after the line (with "before", before it); stage k is
# stamps k-1 .. k
STAMPS = (("  cg::cluster_group cluster = cg::this_cluster();", "before"),
          ("      mbar_wait(b, 0);", "after"),
          ("  if (threadIdx.x == 0) part = make_float2(m, l);", "after"),
          ("  cluster.sync();                       // every CTA's part is written and visible",
           "after"),
          ("  cluster_arrive();                     // done with the other CTAs' shared memory",
           "after"),
          ("  cluster_wait();                       // no CTA leaves while another may read its "
           "part", "before"),
          ("  cluster_wait();                       // no CTA leaves while another may read its "
           "part", "after"))
STAGES = ("launch to chunk copied", "the CTA's (m, l)", "cluster barrier",
          "the row's (M, L)", "write issued", "second barrier")
MAX_CTAS = 4096
STAMP_HELPERS = f"""
__device__ unsigned long long g_clock[{MAX_CTAS}][{len(STAMPS)}];
__device__ unsigned long long g_timer[{MAX_CTAS}][{len(STAMPS)}];
__shared__ unsigned long long s_clock[{len(STAMPS)}], s_timer[{len(STAMPS)}];
__device__ __forceinline__ void stamp(int k) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    s_timer[k] = t;
    s_clock[k] = clock64();
  }}
}}
__device__ __forceinline__ void stamps_out() {{
  if (threadIdx.x == 0 && blockIdx.x < {MAX_CTAS})
    for (int k = 0; k < {len(STAMPS)}; ++k) {{
      g_clock[blockIdx.x][k] = s_clock[k];
      g_timer[blockIdx.x][k] = s_timer[k];
    }}
}}
"""
STAMP_EXPORT = """
extern "C" int tsl_softmax_stamps(void* clocks, void* timers, int bytes) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, g_clock, bytes);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(timers, g_timer, bytes);
  return static_cast<int>(err);
}
"""


def _build(name: str, text: str):
    from repro_torch.kernels.common import KERNEL_BUILD_ROOT, load_shared_library
    from repro_torch.kernels.softmax import kernel

    work = KERNEL_BUILD_ROOT / "softmax_anatomy" / name
    work.mkdir(parents=True, exist_ok=True)
    (work / kernel.SOURCES[0].name).write_text(text)
    return load_shared_library(name, [work / kernel.SOURCES[0].name])


def cut_library(stage: str):
    """The C function of a copy of softmax.cu cut after ``stage``."""
    from repro_torch.kernels.softmax import kernel

    (src,) = kernel.SOURCES
    old, new = CUTS[stage]
    text = src.read_text()
    if text.count(old) != 1:
        raise AssertionError(f"{stage}: {old!r} is not once in {src}")
    name = "softmax_cut_" + "".join(c if c.isalnum() else "_" for c in stage).strip("_")
    return kernel.bind(_build(name, text.replace(old, new)))


def variant_library(variant: str):
    """The C function of a copy of softmax.cu with ``variant`` applied."""
    from repro_torch.kernels.softmax import kernel

    old, new = VARIANTS[variant]
    text = kernel.SOURCES[0].read_text()
    if old not in text:
        raise AssertionError(f"{variant}: {old!r} is not in softmax.cu")
    text = text.replace(old, new)
    if new.startswith("ex2_ftz"):
        text = text.replace("namespace {\n", "namespace {\n" + EX2_FTZ, 1)
    name = "softmax_variant_" + "".join(c if c.isalnum() else "_" for c in variant)
    return kernel.bind(_build(name, text))


def stamped_source(text: str) -> str:
    """softmax.cu with the stamps of STAMPS and the function that reads them."""
    text = text.replace("namespace {\n", "namespace {\n" + STAMP_HELPERS, 1)
    done = set()
    for k, (line, where) in enumerate(STAMPS):
        if text.count(line) != 1:
            raise AssertionError(f"stamp {k}: {line!r} is not once in softmax.cu")
        at = text.index(line) + (0 if where == "before" else len(line))
        if (line, where) in done:
            raise AssertionError(f"stamp {k} repeats {line!r} {where}")
        done.add((line, where))
        last = "\n  stamps_out();" if k == len(STAMPS) - 1 else ""
        text = text[:at] + (f"stamp({k});\n  " if where == "before" else
                            f"\n  stamp({k});{last}") + text[at:]
    return text + STAMP_EXPORT


def stamps(lib, rows: int, cluster: int) -> dict:
    """The stamps of the last call of ``lib`` (rows * cluster CTAs): per stage
    the cycles per CTA, the CTAs' start and end spreads and the span in ns."""
    import ctypes
    import statistics

    n = rows * cluster
    words = MAX_CTAS * len(STAMPS)
    clocks, timers = (ctypes.c_ulonglong * words)(), (ctypes.c_ulonglong * words)()
    fn = lib.tsl_softmax_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    err = fn(ctypes.addressof(clocks), ctypes.addressof(timers), words * 8)
    if err != 0:
        raise RuntimeError(f"reading the stamps: cudaError {err}")
    k = len(STAMPS)
    clk = [[clocks[b * k + i] for i in range(k)] for b in range(n)]
    tim = [[timers[b * k + i] for i in range(k)] for b in range(n)]
    out = {}
    for i, stage in enumerate(STAGES):
        cyc = [c[i + 1] - c[i] for c in clk]
        out[stage + " cycles"] = {"median": statistics.median(cyc), "max": max(cyc)}
    whole = [c[-1] - c[0] for c in clk]
    ns = [t[-1] - t[0] for t in tim]
    out["CTA cycles"] = {"median": statistics.median(whole), "max": max(whole)}
    out["CTA ns (globaltimer)"] = {"median": statistics.median(ns), "max": max(ns)}
    out["GHz (cycles / ns, median CTA)"] = statistics.median(
        c / t for c, t in zip(whole, ns) if t > 0) if any(ns) else None
    out["start spread ns"] = max(t[0] for t in tim) - min(t[0] for t in tim)
    out["end spread ns"] = max(t[-1] for t in tim) - min(t[-1] for t in tim)
    out["span ns"] = max(t[-1] for t in tim) - min(t[0] for t in tim)
    return out


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.softmax import kernel
    from repro_torch.kernels.softmax import ops as sm

    if not torch.cuda.is_available():
        print("softmax_anatomy: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = chip_smoke.gpu_line()
    with ThreadPoolExecutor(len(CUTS) + len(VARIANTS) + 2) as pool:
        stamped = pool.submit(_build, "softmax_stamped",
                              stamped_source(kernel.SOURCES[0].read_text()))
        variants = {v: pool.submit(variant_library, v) for v in VARIANTS}
        fns = dict(zip(list(CUTS) + ["whole kernel"],
                       pool.map(lambda s: cut_library(s) if s in CUTS else kernel._fn(),
                                list(CUTS) + ["whole kernel"])))
        stamped = stamped.result()
        variants = {v: f.result() for v, f in variants.items()}
    whole = kernel._fn
    g = torch.Generator(device=dev).manual_seed(23)
    tiny = torch.randn((2, 1), generator=g, device=dev)
    out = {"gpu": gpu, "timing": chip_smoke.DEVICE_TIMING,
           "one-warp launch (2, 1) f32 ms": chip_smoke.graph_ms(lambda: sm.softmax(tiny), 20),
           "cases": []}
    try:
        for shape, dtype in SHAPES:
            x = (torch.randn(shape, generator=g, device=dev) * 4).to(getattr(torch, dtype))
            y = torch.empty_like(x)
            for cluster in (16, 8):
                row = {"shape": list(shape), "dtype": dtype, "cluster": cluster,
                       "plan": kernel.plan_for(x, y, cluster)._replace(chunks=None)._asdict()}
                for stage, fn in fns.items():
                    kernel._fn = lambda fn=fn: fn
                    row[stage] = chip_smoke.graph_ms(
                        lambda: kernel.softmax_2d(x, y, max_cluster=cluster), 20)
                kernel.softmax_2d(x, y, max_cluster=cluster)    # the whole kernel, last
                row["max_abs_err"] = chip_smoke.check_case(
                    "softmax", list(shape), y, sm.ref.softmax(x), x.dtype,
                    atol_scale=1 / shape[-1])["max_abs_err"]
                if cluster == 16:
                    for variant, fn in variants.items():
                        kernel._fn = lambda fn=fn: fn
                        row[variant] = chip_smoke.graph_ms(
                            lambda: kernel.softmax_2d(x, y, max_cluster=cluster), 20)
                        kernel.softmax_2d(x, y, max_cluster=cluster)
                        row[variant + " max_abs_err"] = chip_smoke.check_case(
                            "softmax " + variant, list(shape), y, sm.ref.softmax(x), x.dtype,
                            atol_scale=1 / shape[-1])["max_abs_err"]
                    kernel._fn = lambda: fns["whole kernel"]
                    row["whole kernel, again"] = chip_smoke.graph_ms(
                        lambda: kernel.softmax_2d(x, y, max_cluster=cluster), 20)
                kernel._fn = lambda: kernel.bind(stamped)
                row["stamped kernel"] = chip_smoke.graph_ms(
                    lambda: kernel.softmax_2d(x, y, max_cluster=cluster), 20)
                kernel.softmax_2d(x, y, max_cluster=cluster)
                torch.cuda.synchronize()
                row["stamps"] = stamps(stamped, shape[0], row["plan"]["cluster"])
                out["cases"].append(row)
                print(json.dumps(row), flush=True)
    finally:
        kernel._fn = whole
    print(gpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
