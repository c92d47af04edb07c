#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py          # from the repo root, one card, no arguments

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Kernels. Builds every kernel of the main paths from the sources in the
   checkout (nvcc for the CUDA C++ flash and paged attention, range_count,
   hadd and to_integral, all started at once; Triton JIT for rmsnorm, swiglu
   and softmax), runs each wrapper on the
   card at the main paths' shapes and holds it against its plain PyTorch
   version on the same inputs within the stated tolerance; times kernel,
   plain version and the one PyTorch library call that computes the same
   function (a yardstick only: the port never calls it) with CUDA events,
   and computes each case's bound from the bytes and operations its inputs
   need against the H100 SXM datasheet peaks. No single PyTorch call
   computes paged attention: its yardstick is scaled_dot_product_attention
   on the same rows already gathered into contiguous lanes (gather not
   timed); none computes a range count or packs a mask (library "—").
   For the paged serving shape it also times the host's enqueue of
   one call: wrapper, bare launcher and the yardstick. The app's kernels
   run at the app's sizes (2^30 float32, 2^28 int32, the (2^25, 32) mask)
   and at edge lengths (0, 1, 31, 33, 2^20 + 7; bit 31; a view off 16-byte
   alignment; fractional bounds on int32 data; NaN data); their integer
   results must equal the plain versions' bit for bit.
2. Model. qwen1.5-0.5b at full width (24 layers, d=1024, vocab 151936 padded
   to 152064, bf16, seeded init): Model.prefill on a (2, 512) prompt then 8
   greedy decode steps through the h100 library; the same prefill with the
   plain versions bound on the card (torch_cpu library) must agree. Then one
   fused paged decode step at batch 8 over 256 prefilled rows, through the
   paged kernel and through its plain version on the same pools: logits
   must agree as the prefill's do, and the argmax must be equal.
3. Serve. repro_torch.launch.serve.main at full width: 16 requests of 256
   prompt tokens and 64 generated tokens over 8 slots, 64-token chunks.
3b. Paged serve. ServeEngine(paged=PagedConfig(page_size=64)) at full width
   with phase 2's params: 32 requests sharing a 128-token system prompt plus
   128 tokens each, 64 generated, 8 slots, max_len 320, 64-token chunks,
   greedy. Fails unless decode ran fused (no lane activation), the prefix
   was shared, nothing was refused, every request got 64 tokens and the
   paged kernel launched 24 times per decode step; prints the share of
   requests whose tokens equal a lane-mode run's on the same requests
   (information only: bf16 kernels may flip a near-tied argmax).
3c. App. The paper's range-count app (Fig 8) through
   repro_torch.launch.quickstart.main on 2^30 float32 uniforms in
   [0, 100000) (4 GiB, the paper's size) and 2^28 int32 in [0, 100), each
   with the quickstart's range and one that selects about half: the fused,
   popcount, composed and hand-written counts must be equal, and a 2^20
   prefix's count equal the torch_cpu library's on the host. Each way is
   timed (GiB/s against 3.35 TB/s), and the composed way's peak memory read.
3d. Generated suite. The h100 library generated with its tests (paper
   §4.1); every generated test function runs on the card; any failure
   fails the phase.
4. Step profile. The step kinds the serving engines run, on phase 2's
   model at the serve phases' shapes — a lane decode step and a fused paged
   decode step over 8 slots at position 256, and one 64-token prefill chunk
   into a batch-1 donor — each timed on the host clock (synchronised wall
   per step) and traced with torch.profiler (device busy time, kernel
   launches, the kernels that take the time). The device's idle share is
   1 - busy / wall.

The launch counters are set to 0 before phase 2 and read after phase 3:
every kernel of that main path must have launched on it (flash attention in
Model.prefill, rmsnorm and swiglu in every layer of serving). They are set
to 0 again just before phase 3b and read just after it for the paged path
(paged attention, rmsnorm and swiglu), just before phase 3c and read just
after it for the app path (range_count, hadd, to_integral), and just
before phase 3d and read just after it for the suite (softmax). Launches
made to compare a kernel with its plain version are not counted.

Stdout ends with the card's name and power limit (nvidia-smi), one JSON line
{"kernels": [...]}, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks (dense): the roofline the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
                  # int32 outside the tensor cores: half the f32 rate (an
                  # H100 SM has 64 INT32 lanes beside its 128 FP32 lanes)
                  "torch.int32": 33.5e12}

# |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output may differ
# by one rounding step (2^-7 relative) where the f32 sums round differently;
# f32 differs only by summation order. Softmax scales ATOL by 1/d on rows
# of width d (check_case's atol_scale): a probability is ~1/d, not ~1
TOLERANCE = {"torch.bfloat16": (1e-2, 1e-2), "torch.float32": (1e-4, 1e-4)}

ARCH = "qwen1.5-0.5b"
PREFILL_SHAPE = (2, 512)
DECODE_STEPS = 8
# end-to-end bf16 bound for prefill logits, kernels vs plain versions:
# ||kernels - plain||_2 / ||plain||_2 over the last-position logits
LOGITS_REL_L2 = 3e-2
SERVE_ARGS = ["--arch", ARCH, "--batch", "8", "--prompt-len", "256", "--gen-len", "64",
              "--requests", "16", "--prefill-chunk", "64", "--device", "cuda"]
# phase 3b: paged serving with a shared system prompt
PAGED_REQUESTS, PAGED_SYSTEM, PAGED_UNIQUE, PAGED_GEN = 32, 128, 128, 64
PAGED_BATCH, PAGED_MAX_LEN, PAGED_CHUNK, PAGE = 8, 320, 64, 64
# phase 4: the serve phase's slot table (8 slots of 256 + 64 rows), decode at
# the first generated position, a chunk that ends there; 10 traced steps
PROFILE_BATCH, PROFILE_FILL, PROFILE_CHUNK, PROFILE_GEN = 8, 256, 64, 64
PROFILE_STEPS = 10
# app phase: the paper's range-count data (bench_fig10_applicability: 2^30
# uniform floats in [0, 100000), 4 GiB) and 2^28 int32 in [0, 100); the
# quickstart's range and one that selects about half
APP_F32_N, APP_I32_N = 1 << 30, 1 << 28
APP_CASES = (("float32", APP_F32_N, ((5.0, 15.0), (25000.0, 75000.0))),
             ("int32", APP_I32_N, ((5, 15), (25, 74))))
# phase 1: edge lengths of the app's kernels (0, 1, around a warp, and a
# length no power of two divides); the vocabulary row width for softmax
EDGE = (1 << 20) + 7
EDGE_LENGTHS = (0, 1, 31, 33, EDGE)
VOCAB_ROW = 152064
APP_CHECK_N = 1 << 20       # prefix also counted on the host (torch_cpu)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after a warm-up (inputs stay L2-warm, as on the main path, where each
    input was just written by the previous op)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call in microseconds, enqueue only: the loop
    does not synchronise (the device drains it afterwards)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def check_case(name, shape, got, want, dtype, nan_ok: bool = False,
               atol_scale: float = 1.0) -> dict:
    """Kernel vs plain within TOLERANCE; ``nan_ok``: NaN where (and only
    where) the plain version has NaN, the rest compared. ``atol_scale``
    puts ATOL in the output's own units where a typical value is not ~1:
    softmax passes 1/d, so on a row of width d it compares
    |kernel - plain| <= ATOL/d + RTOL |plain| (d·softmax has mean 1)."""
    import torch

    torch.cuda.synchronize()
    if nan_ok:
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{name} {shape}: NaN where the plain version has none "
                                 f"or the reverse")
        keep = ~torch.isnan(want)
        got, want = got[keep], want[keep]
    diff = (got.float() - want.float()).abs()
    atol, rtol = TOLERANCE[str(dtype)]
    atol *= atol_scale
    limit = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} {shape}: non-finite output")
    bad = int((diff > limit).sum())
    if bad:
        raise AssertionError(f"{name} {shape} {dtype}: {bad} elements exceed "
                             f"atol {atol} + rtol {rtol}; max abs err {diff.max().item()}")
    big = want.float().abs() >= atol          # relative error where it means something
    rel = (diff[big] / want.float().abs()[big]).max().item() if bool(big.any()) else 0.0
    return {"max_abs_err": diff.max().item(), "max_rel_err": rel,
            "tolerance_used": (diff / limit).max().item(), "atol": atol, "rtol": rtol}


def check_exact(name, shape, got, want) -> dict:
    """Integer results (counts, sums, bit words): kernel == plain, bit for bit."""
    import torch

    torch.cuda.synchronize()
    g, w = (t.view(torch.int32) if t.dtype == torch.uint32 else t for t in (got, want))
    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
        err = (g.long() - w.long()).abs().max().item() if g.shape == w.shape else "shape"
        raise AssertionError(f"{name} {shape}: kernel != plain ({got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}; "
                             f"max abs err {err})")
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance_used": 0.0, "atol": 0,
            "rtol": 0}


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev) -> list[dict]:
    """Phase 1: every kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.common import KERNEL_BUILD_ROOT
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.hadd import kernel as ha_kernel
    from repro_torch.kernels.paged import kernel as pa_kernel
    from repro_torch.kernels.paged import ops as pa
    from repro_torch.kernels.range_count import kernel as rc_kernel
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.swiglu import ops as sw
    from repro_torch.kernels.to_integral import kernel as ti_kernel

    t0 = time.perf_counter()
    # nvcc builds of the CUDA sources (cached by digest), one per source, at once
    cuda = {"flash_attention": fa_kernel, "paged_attention": pa_kernel,
            "range_count": rc_kernel, "hadd": ha_kernel, "to_integral": ti_kernel}
    with ThreadPoolExecutor(len(cuda)) as pool:
        list(pool.map(lambda k: k._fn(), cuda.values()))
    print(f"[phase1] {', '.join(cuda)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in cuda:
        for log in sorted(KERNEL_BUILD_ROOT.glob(f"{name}_*/build.log")):
            regs = [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"[phase1] ptxas {name}:", "; ".join(regs), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows_list = (4, 8, 64, 1024, 4096)   # 8: decode batch, 64: chunk, 1024: B*S
    results = []

    cases = []
    for rows in rows_list:
        x, w = rnd(rows, 1024), rnd(1024)
        got = rn.rmsnorm(x, w)
        want = rn.ref.rmsnorm(x, w)
        c = {"shape": [rows, 1024], "dtype": "bfloat16",
             **check_case("rmsnorm", (rows, 1024), got, want, x.dtype)}
        c["ms"] = cuda_ms(lambda: rn.rmsnorm(x, w), 100)
        c["plain_ms"] = cuda_ms(lambda: rn.ref.rmsnorm(x, w), 100)
        c["library_ms"] = cuda_ms(lambda: F.rms_norm(x, (1024,), w, 1e-6), 100)
        c["bound_ms"], c["bound_by"] = bound((2 * rows * 1024 + 1024) * 2,
                                             4 * rows * 1024, x.dtype)
        cases.append(c)
    results.append(("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                    "src/repro/kernels/rmsnorm/kernel.py:31", [1024, 1024], cases))

    cases = []
    for rows in rows_list:
        gt, up = rnd(rows, 2816), rnd(rows, 2816)
        got = sw.swiglu(gt, up)
        want = sw.ref.swiglu(gt, up)
        c = {"shape": [rows, 2816], "dtype": "bfloat16",
             **check_case("swiglu", (rows, 2816), got, want, gt.dtype)}
        c["ms"] = cuda_ms(lambda: sw.swiglu(gt, up), 100)
        c["plain_ms"] = cuda_ms(lambda: sw.ref.swiglu(gt, up), 100)
        c["library_ms"] = cuda_ms(lambda: F.silu(gt) * up, 100)
        c["bound_ms"], c["bound_by"] = bound(3 * rows * 2816 * 2, 4 * rows * 2816,
                                             gt.dtype)
        cases.append(c)
    results.append(("swiglu", "triton", "src/repro_torch/kernels/swiglu/kernel.py",
                    "src/repro/kernels/swiglu/kernel.py:22", [1024, 2816], cases))

    # (B, H, KH, Sq, Sk, D, dtype, causal, kv_len)
    fa_cases = [
        (2, 16, 16, 512, 512, 64, torch.bfloat16, True, None),   # Model.prefill
        (4, 16, 16, 512, 512, 64, torch.bfloat16, True, None),
        (1, 8, 2, 256, 256, 128, torch.bfloat16, True, None),    # GQA, D=128
        (2, 16, 16, 64, 320, 64, torch.bfloat16, True, 300),     # continuation
        (2, 16, 16, 512, 512, 64, torch.float32, True, None),
    ]
    cases = []
    for b, h, kh, sq, sk, d, dt, causal, kv_len in fa_cases:
        q, k, v = rnd(b, h, sq, d, dtype=dt), rnd(b, kh, sk, d, dtype=dt), \
            rnd(b, kh, sk, d, dtype=dt)
        got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        want = fa.ref.attention(q, k, v, causal=causal, kv_len=kv_len)
        shape = [b, h, kh, sq, sk, d]
        c = {"shape": shape, "dtype": str(dt).removeprefix("torch."),
             "kv_len": kv_len, **check_case("flash_attention", shape, got, want, dt)}
        c["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                     kv_len=kv_len), 20)
        c["plain_ms"] = cuda_ms(lambda: fa.ref.attention(q, k, v, causal=causal,
                                                         kv_len=kv_len), 20)
        kvl = sk if kv_len is None else kv_len
        qi = torch.arange(sq, device=dev)[:, None] + (kvl - sq)
        kj = torch.arange(sk, device=dev)[None, :]
        allowed = (kj < kvl) & ((kj <= qi) if causal else True)
        pairs = int(allowed.sum())                   # what this data needs
        mask = None if (kv_len is None and sq == sk) else allowed
        c["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != kh), 20)
        itemsize = q.element_size()
        c["bound_ms"], c["bound_by"] = bound(
            (2 * b * h * sq * d + 2 * b * kh * sk * d) * itemsize,
            4 * b * h * pairs * d, dt)
        cases.append(c)
    results.append(("flash_attention", "cuda",
                    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention/kernel.py:185",
                    [2, 16, 16, 512, 512, 64], cases))
    results.append(("paged_attention", "cuda",
                    "src/repro_torch/kernels/paged/csrc/paged_attention.cu",
                    "src/repro/kernels/paged/kernel.py:88", None,
                    paged_cases(dev, pa)))
    results.append(("range_count", "cuda",
                    "src/repro_torch/kernels/range_count/csrc/range_count.cu",
                    "src/repro/kernels/range_count/kernel.py:52", None,
                    range_count_cases(dev)))
    results.append(("hadd", "cuda", "src/repro_torch/kernels/hadd/csrc/hadd.cu",
                    "src/repro/kernels/hadd/kernel.py:46", None, hadd_cases(dev)))
    results.append(("to_integral", "cuda",
                    "src/repro_torch/kernels/to_integral/csrc/to_integral.cu",
                    "src/repro/kernels/to_integral/kernel.py:31", None,
                    to_integral_cases(dev)))
    results.append(("softmax", "triton", "src/repro_torch/kernels/softmax/kernel.py",
                    "src/repro/kernels/softmax/kernel.py:24", None, softmax_cases(dev)))

    rows = []
    for name, route, source, replaces, main_shape, cs in results:
        top = next(c for c in cs if c.get("main", c["shape"] == main_shape))
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": max(c["max_abs_err"] for c in cs),
                     "tolerance_used": max(c["tolerance_used"] for c in cs),
                     "ms": top["ms"], "plain_ms": top["plain_ms"],
                     "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                     "library_ms": top["library_ms"], "shape": top["shape"],
                     "cases": cs})
        for c in cs:
            lib = "—" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            print(f"[phase1] {name} {c['shape']} {c['dtype']}: err {c['max_abs_err']:.3g} "
                  f"(rel {c['max_rel_err']:.3g}, {c['tolerance_used']:.2f} of tolerance) "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"library {lib} bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})"
                  + (f" {c['note']}" if "note" in c else "")
                  + (f"; host enqueue us {json.dumps(c['host_us'])}" if "host_us" in c
                     else ""), flush=True)
    return rows


def paged_operands(dev, dtype, b, h, kh, d, page, sq, kv_lens, width, seed=0):
    """q, pools and tables for one paged case: each sequence's pages are a
    slice of one permutation of the pool; page 0 is the scratch page that
    pads every table row past its coverage."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    used = [-(-n // page) for n in kv_lens]
    n_pages = 1 + sum(used) + 2
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))
            + 1).tolist()
    tables = torch.zeros(b, width, dtype=torch.int32)
    for i, u in enumerate(used):
        tables[i, :u] = torch.tensor(perm[:u], dtype=torch.int32)
        perm = perm[u:]
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(kh, n_pages, page, d, generator=g, device=dev).to(dtype)
    v = torch.randn(kh, n_pages, page, d, generator=g, device=dev).to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return q, k, v, tables.to(dev), kv_len


def paged_cases(dev, pa) -> list[dict]:
    """Phase 1, paged attention: the serving path's decode shape with the
    kv_len of a steady decode step (the main case) and with edge lengths (0,
    1, partial pages, a full table), a GQA verify-shaped span, and f32."""
    import torch
    import torch.nn.functional as F

    steady = [260, 268, 276, 284, 292, 300, 308, 316]
    edges = [0, 1, 100, 320, 257, 64, 63, 200]
    # (B, H, KH, D, page, SQ, kv_len per sequence, table width, dtype, main)
    specs = [
        (8, 16, 16, 64, PAGE, 1, steady, 5, torch.bfloat16, True),
        (8, 16, 16, 64, PAGE, 1, edges, 5, torch.bfloat16, False),
        (3, 40, 8, 128, 16, 4, [2, 37, 64], 4, torch.bfloat16, False),
        (8, 16, 16, 64, PAGE, 1, edges, 5, torch.float32, False),
    ]
    cases = []
    for b, h, kh, d, page, sq, kv_lens, width, dt, main in specs:
        q, k, v, tables, kv_len = paged_operands(dev, dt, b, h, kh, d, page, sq, kv_lens,
                                                 width)
        assert not torch.equal(k, v)
        shape = [b, h, kh, d, page, sq, width]
        got = pa.paged_attention(q, k, v, tables, kv_len)
        want = pa.ref.paged_attention_ref(q, k, v, tables, kv_len)
        c = {"shape": shape, "dtype": str(dt).removeprefix("torch."), "kv_len": kv_lens,
             "main": main, **check_case("paged_attention", shape, got, want, dt)}
        c["ms"] = cuda_ms(lambda: pa.paged_attention(q, k, v, tables, kv_len), 50)
        c["plain_ms"] = cuda_ms(lambda: pa.ref.paged_attention_ref(q, k, v, tables,
                                                                   kv_len), 10)
        # yardstick: SDPA on the same rows gathered into contiguous lanes
        lanes_k = k[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(b, kh, -1, d)
        lanes_v = v[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(b, kh, -1, d)
        qpos = kv_len.long()[:, None] - sq + torch.arange(sq, device=dev)[None, :]
        mask = (torch.arange(width * page, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]                    # (B, 1, SQ, S)
        c["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, lanes_k, lanes_v, attn_mask=mask, enable_gqa=h != kh), 50)
        if main:
            # host time to enqueue one call (no synchronise inside the loop)
            out = torch.empty_like(q)
            c["host_us"] = {
                "wrapper": host_us(lambda: pa.paged_attention(q, k, v, tables, kv_len)),
                "launcher": host_us(lambda: pa.kernel.paged_attention_4d(
                    q, k, v, tables, kv_len, out, tile=64, scale=d ** -0.5)),
                "library": host_us(lambda: F.scaled_dot_product_attention(
                    q, lanes_k, lanes_v, attn_mask=mask, enable_gqa=h != kh))}
        # what this data needs: the touched pages of K and V, q and the
        # output once, the table entries read and kv_len; 4*D flops per
        # visible (query row, key) pair
        touched = sum(-(-n // page) for n in kv_lens)
        itemsize = q.element_size()
        pairs = sum(max(0, n - sq + s + 1) for n in kv_lens for s in range(sq)) * h
        c["bound_ms"], c["bound_by"] = bound(
            2 * kh * touched * page * d * itemsize + 2 * b * h * sq * d * itemsize
            + 4 * touched + 4 * b, 4 * pairs * d, dt)
        cases.append(c)
    return cases


def _timed(case: dict, kernel_fn, plain_fn, library_fn, iters: int) -> dict:
    """Adds the kernel's, the plain version's and the library call's ms."""
    case["ms"] = cuda_ms(kernel_fn, iters)
    case["plain_ms"] = cuda_ms(plain_fn, iters)
    case["library_ms"] = cuda_ms(library_fn, iters) if library_fn is not None else None
    return case


def range_count_cases(dev) -> list[dict]:
    """Phase 1, range_count: the app's 2^30 float32 uniforms (the main
    case) and 2^28 int32, edge lengths (0, 1, 31, 33, 2^20 + 7, a view off
    16-byte alignment), a fractional bound on int32 data and NaN data.
    Counts must be equal. No single PyTorch call computes a range count."""
    import torch

    from repro_torch.kernels.range_count import ops as rc

    g = torch.Generator(device=dev).manual_seed(10)
    big = torch.rand(APP_F32_N, generator=g, device=dev).mul_(100_000)
    ints = torch.randint(0, 100, (APP_I32_N,), generator=g, device=dev, dtype=torch.int32)
    nan = torch.rand(EDGE, generator=g, device=dev).mul_(20)
    nan[::3] = float("nan")
    # (label, data, lo, hi, main)
    specs = [("f32", big, 5.0, 15.0, True), ("f32", big, 25000.0, 75000.0, False),
             ("i32", ints, 5, 15, False), ("i32", ints, 25, 74, False)]
    for n in EDGE_LENGTHS:
        specs += [("f32", big[:n].mul(1e-3), 5.0, 15.0, False),
                  ("i32", ints[:n], 10, 40, False)]
    small = big[:EDGE + 1].mul(1e-3)
    specs += [("f32 view 4 bytes off 16-byte alignment", small[1:], 5.0, 15.0, False),
              ("i32 fractional bounds", ints[:EDGE], 5.5, 7.9, False),
              ("i32 int lo, float hi", ints[:EDGE], 5, 7.9, False),
              ("f32 NaN data", nan, 2.0, 9.0, False)]
    cases = []
    for label, data, lo, hi, main in specs:
        n = data.numel()
        shape = [n, label, lo, hi]
        c = {"shape": shape, "dtype": str(data.dtype).removeprefix("torch."), "main": main,
             **check_exact("range_count", shape, rc.range_count(data, lo, hi),
                           rc.ref.range_count(data, lo, hi))}
        iters = 10 if n >= APP_I32_N else 50
        _timed(c, lambda: rc.range_count(data, lo, hi),
               lambda: rc.ref.range_count(data, lo, hi), None, iters)
        c["bound_ms"], c["bound_by"] = bound(n * data.element_size() + 4, 3 * n,
                                             torch.int32 if data.dtype == torch.int32
                                             else torch.float32)
        cases.append(c)
    return cases


def hadd_cases(dev) -> list[dict]:
    """Phase 1, hadd: the composed app's one row of 2^30 int32 0/1 lanes
    (the main case), (64, 512) rows (the bench shape) in f32 and bf16, row
    lengths 0, 1, 31, 33 and 2^20 + 7 in f32 / bf16 / int32, and an int32
    row whose sum passes 2^24 (exact) and one that wraps past 2^31."""
    import torch

    from repro_torch.kernels.hadd import ops as ha

    g = torch.Generator(device=dev).manual_seed(11)

    def rand(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=g, device=dev,
                                 dtype=torch.int32)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    lanes = torch.randint(0, 2, (APP_F32_N,), generator=g, device=dev, dtype=torch.int32)
    specs = [(lanes, True, "the composed app's lanes"),
             (rand((64, 512), torch.float32), False, "bench shape"),
             (rand((64, 512), torch.bfloat16), False, "bench shape")]
    for n in EDGE_LENGTHS:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            specs.append((rand((3, n), dt), False, ""))
    specs += [
        (torch.randint(0, 1 << 10, (EDGE,), generator=g, device=dev,
                       dtype=torch.int32), False, "int32 sum past 2^24"),
        (torch.full((5000,), 1 << 20, device=dev, dtype=torch.int32), False,
         "int32 sum wraps past 2^31"),
        (rand((8, VOCAB_ROW), torch.bfloat16), False, "vocab rows"),
    ]
    cases = []
    for x, main, note in specs:
        shape = list(x.shape)
        got, want = ha.hadd(x), ha.ref.hadd(x)
        check = (check_exact("hadd", shape, got, want) if x.dtype == torch.int32
                 else check_case("hadd", shape, got, want, x.dtype))
        c = {"shape": shape, "dtype": str(x.dtype).removeprefix("torch."), "main": main,
             **check}
        if note:
            c["note"] = note
        iters = 10 if x.numel() >= APP_I32_N else 50
        _timed(c, lambda: ha.hadd(x), lambda: ha.ref.hadd(x),
               lambda: torch.sum(x, -1, dtype=x.dtype), iters)
        rows = math.prod(x.shape[:-1])
        c["bound_ms"], c["bound_by"] = bound(
            (x.numel() + rows) * x.element_size(), x.numel(),
            torch.int32 if x.dtype == torch.int32 else torch.float32)
        cases.append(c)
    return cases


def to_integral_cases(dev) -> list[dict]:
    """Phase 1, to_integral: the app's mask packed 32 lanes a word ((2^25,
    32) bool, the main case), row counts 1, 31, 33 and 2^20 + 7, lane counts
    1, 31 and 32 with bit 31 (every lane set; only lane 31 set), and uint8
    masks. Words must be equal. No PyTorch call packs a mask."""
    import torch

    from repro_torch.kernels.to_integral import ops as ti

    g = torch.Generator(device=dev).manual_seed(12)

    def mask(rows, n):
        return torch.rand((rows, n), generator=g, device=dev) > 0.5

    full = torch.ones((4, 32), dtype=torch.bool, device=dev)
    top = torch.zeros((4, 32), dtype=torch.bool, device=dev)
    top[:, 31] = True
    specs = [(mask(APP_F32_N // 32, 32), True), (full, False), (top, False),
             (mask(7, 1), False), (mask(7, 31), False), (mask(0, 32), False),
             (mask(5, 32).to(torch.uint8), False)]
    for rows in EDGE_LENGTHS[1:]:
        specs.append((mask(rows, 32), False))
    cases = []
    for m, main in specs:
        shape = list(m.shape)
        c = {"shape": shape, "dtype": str(m.dtype).removeprefix("torch."), "main": main,
             **check_exact("to_integral", shape, ti.to_integral(m), ti.ref.to_integral(m))}
        _timed(c, lambda: ti.to_integral(m), lambda: ti.ref.to_integral(m), None,
               10 if m.numel() >= APP_I32_N else 50)
        c["bound_ms"], c["bound_by"] = bound(m.numel() + 4 * shape[0], m.numel(),
                                             torch.int32)
        cases.append(c)
    if not torch.equal(ti.to_integral(full).view(torch.int32),
                       torch.full((4,), -1, dtype=torch.int32, device=dev)):
        raise AssertionError("to_integral: 32 set lanes are not 0xFFFFFFFF")
    return cases


def softmax_cases(dev) -> list[dict]:
    """Phase 1, softmax: vocabulary rows ((8, 152064) bf16, the main case:
    wider than one block, online max/sum) with -inf lanes, the same in f32
    and with a row of only -inf (NaN, as the plain version gives), flat
    rows (unit logits: no entry dominates, so a fault in the small entries
    or the tail block shows against ATOL/d), rows that
    fit one block ((4096, 1024) f32, (64, 512) bf16), the generated suite's
    shapes, and widths 1, 31, 33 and 2^20 + 7."""
    import torch

    from repro_torch.kernels.softmax import ops as sm

    g = torch.Generator(device=dev).manual_seed(13)

    def rand(shape, dtype, neg_inf=False, dead_row=False, scale=4.0):
        x = torch.randn(shape, generator=g, device=dev).mul_(scale)
        if neg_inf:
            x[:, ::7] = float("-inf")
            x[0, : shape[1] // 2] = float("-inf")
        if dead_row:
            x[1] = float("-inf")
        return x.to(dtype)

    specs = [(rand((8, VOCAB_ROW), torch.bfloat16, neg_inf=True), True),
             (rand((8, VOCAB_ROW), torch.float32, neg_inf=True), False),
             (rand((8, VOCAB_ROW), torch.float32, dead_row=True), False),
             (rand((8, VOCAB_ROW), torch.bfloat16, neg_inf=True, scale=1.0), False),
             (rand((8, VOCAB_ROW), torch.float32, scale=1.0), False),
             (rand((4096, 1024), torch.float32), False),
             (rand((64, 512), torch.bfloat16, neg_inf=True), False),
             (rand((7, 33), torch.float32), False), (rand((4, 16), torch.bfloat16), False),
             (rand((3, 9000), torch.float32, neg_inf=True), False)]
    for d in EDGE_LENGTHS[1:]:
        specs.append((rand((2, d), torch.float32), False))
    cases = []
    for x, main in specs:
        shape = list(x.shape)
        c = {"shape": shape, "dtype": str(x.dtype).removeprefix("torch."), "main": main,
             **check_case("softmax", shape, sm.softmax(x), sm.ref.softmax(x), x.dtype,
                          nan_ok=True, atol_scale=1 / shape[-1])}
        _timed(c, lambda: sm.softmax(x), lambda: sm.ref.softmax(x),
               lambda: torch.softmax(x, -1), 20)
        c["bound_ms"], c["bound_by"] = bound(2 * x.numel() * x.element_size(),
                                             5 * x.numel(), torch.float32)
        cases.append(c)
    return cases


def counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.hadd.ops import hadd
    from repro_torch.kernels.paged.ops import paged_attention
    from repro_torch.kernels.range_count.ops import range_count
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.softmax.ops import softmax
    from repro_torch.kernels.swiglu.ops import swiglu
    from repro_torch.kernels.to_integral.ops import to_integral

    return {"rmsnorm": rmsnorm, "swiglu": swiglu, "flash_attention": flash_attention,
            "paged_attention": paged_attention, "range_count": range_count, "hadd": hadd,
            "to_integral": to_integral, "softmax": softmax}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def model_phase(dev, gpu: str) -> tuple[dict, object, dict]:
    """Phase 2: full-width prefill + greedy decode through the kernels, and
    the same prefill through the plain versions on the card. Returns the
    result, the model and its params."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import build_model

    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    assert model.lib.TARGET_NAME == "h100", model.lib.TARGET_NAME
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, PREFILL_SHAPE, generator=g, device=dev)
    max_len = PREFILL_SHAPE[1] + DECODE_STEPS
    out = {"params": n_params}
    with torch.inference_mode():
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = model.prefill(params, {"tokens": tokens}, max_len)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        after = read_counts()
        out["prefill_launches"] = {k: after[k] - before[k] for k in after}
        if out["prefill_launches"]["flash_attention"] < cfg.n_layers:
            raise AssertionError(f"flash attention launched "
                                 f"{out['prefill_launches']['flash_attention']} times "
                                 f"in a {cfg.n_layers}-layer prefill")
        if tuple(last.shape) != (PREFILL_SHAPE[0], cfg.padded_vocab) \
                or not torch.isfinite(last.float()).all():
            raise AssertionError(f"prefill logits {tuple(last.shape)} not finite/shaped")
        toks = last[:, :cfg.vocab].argmax(-1)
        generated = []
        for i in range(DECODE_STEPS):
            before = read_counts()
            logits, state = model.decode_step(params, state, toks[:, None],
                                              PREFILL_SHAPE[1] + i)
            after = read_counts()
            if not torch.isfinite(logits.float()).all():
                raise AssertionError(f"decode step {i}: non-finite logits")
            toks = logits[:, :cfg.vocab].argmax(-1)
            generated.append(toks.tolist())
        out["decode_step_launches"] = {k: after[k] - before[k] for k in after}
        out["greedy_tokens"] = generated
        # one serving-shape prefill chunk (64 tokens into a batch-1 donor)
        donor = model.init_decode_state(1, max_len)
        before = read_counts()
        model.prefill_chunk(params, donor, tokens[:1, :64], 0)
        after = read_counts()
        out["prefill_chunk_launches"] = {k: after[k] - before[k] for k in after}

        plain = build_model(cfg, device=dev, target="torch_cpu")
        want, _ = plain.prefill(params, {"tokens": tokens}, max_len)
        got, want = last.float(), want.float()
        rel = ((got - want).norm() / want.norm()).item()
        out["logits_rel_l2"] = rel
        out["logits_max_abs_err"] = (got - want).abs().max().item()
        out["argmax_kernels"] = got[:, :cfg.vocab].argmax(-1).tolist()
        out["argmax_plain"] = want[:, :cfg.vocab].argmax(-1).tolist()
        if rel > LOGITS_REL_L2:
            raise AssertionError(f"prefill logits: kernels vs plain rel L2 {rel:.3g} "
                                 f"> {LOGITS_REL_L2}")
        for row, (a, p) in enumerate(zip(out["argmax_kernels"], out["argmax_plain"])):
            # a differing argmax must be a near-tie in the plain logits
            gap = (want[row, p] - want[row, a]).item()
            if a != p and gap > LOGITS_REL_L2 * want[row].abs().max().item():
                raise AssertionError(f"row {row}: argmax {a} (kernels) vs {p} (plain), "
                                     f"plain logit gap {gap:.3g}")
        # launches made to compare a kernel with its plain version do not
        # count on the main path
        saved = read_counts()
        out["paged_step"] = paged_model_check(dev, model, params)
        for name, fn in counters().items():
            fn.launches = saved[name]
    print(f"[phase2] {ARCH} {n_params / 1e9:.3f}B params bf16 on {gpu}: "
          f"prefill {PREFILL_SHAPE} {out['prefill_s']:.3f} s (first call, includes "
          f"kernel JIT); launches per prefill {out['prefill_launches']}, per decode "
          f"step {out['decode_step_launches']}, per 64-token prefill chunk "
          f"{out['prefill_chunk_launches']}; logits vs plain rel L2 "
          f"{out['logits_rel_l2']:.3g}, max abs {out['logits_max_abs_err']:.3g}, "
          f"argmax {out['argmax_kernels']} vs {out['argmax_plain']}; fused paged "
          f"decode step, kernel vs plain: {json.dumps(out['paged_step'])}", flush=True)
    return out, model, params


def paged_pools(dev, model, params, batch: int, fill: int, seed: int):
    """Fused pools (L, 1, KH, n_pages, PAGE, hd) holding ``batch`` prefilled
    prompts of ``fill`` tokens behind permuted page tables (page 0 is the
    scratch page), room for the serve phase's max_len; and the (B, P)
    tables on the device."""
    import torch

    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, fill), generator=g, device=dev)
    _, state = model.prefill(params, {"tokens": tokens}, fill)
    width = -(-PAGED_MAX_LEN // PAGE)
    n_pages = 1 + batch * width
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))
            + 1).view(batch, width)
    pools = {n: torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, n_pages, PAGE, cfg.hd),
                            dtype=model.dtype, device=dev) for n in ("k", "v")}
    for b in range(batch):
        for p in range(-(-fill // PAGE)):
            rows = slice(p * PAGE, min((p + 1) * PAGE, fill))
            n_rows = rows.stop - rows.start
            for n in ("k", "v"):
                pools[n][:, 0, :, int(perm[b, p]), :n_rows] = state[n][:, b, :, rows]
    return pools, perm.to(device=dev, dtype=torch.int32)


class _PlainPaged:
    """A library's ops with attention_decode_paged bound to its plain
    version: the model step through the kernel vs through the plain version,
    every other primitive the same."""

    def __init__(self, ops):
        self._ops = ops

    def __getattr__(self, name):
        if name == "attention_decode_paged":
            from repro_torch.kernels.paged.ref import paged_attention_ref
            return paged_attention_ref
        return getattr(self._ops, name)


def paged_model_check(dev, model, params) -> dict:
    """Phase 2, paged: one fused paged decode step at batch 8 over 256
    prefilled rows (kv_len 257), through the paged kernel and through its
    plain version on copies of the same pools."""
    import torch

    from repro_torch.nn import lm

    batch, fill = PROFILE_BATCH, PROFILE_FILL
    pools, tables = paged_pools(dev, model, params, batch, fill, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab, (batch, 1), generator=g, device=dev)
    pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
    logits = {}
    for name, tsl in (("kernel", model.tsl), ("plain", _PlainPaged(model.tsl))):
        copy = {n: t.clone() for n, t in pools.items()}
        logits[name], _, _ = lm.lm_decode_step_paged(tsl, params, {}, copy, tables,
                                                     tokens, pos, model.cfg)
    got, want = logits["kernel"].float(), logits["plain"].float()
    vocab = model.cfg.vocab
    out = {"batch": batch, "kv_len": fill + 1,
           "logits_rel_l2": ((got - want).norm() / want.norm()).item(),
           "logits_max_abs_err": (got - want).abs().max().item(),
           "argmax_kernel": got[:, :vocab].argmax(-1).tolist(),
           "argmax_plain": want[:, :vocab].argmax(-1).tolist()}
    if not torch.isfinite(got).all():
        raise AssertionError("fused paged decode step: non-finite logits")
    if out["logits_rel_l2"] > LOGITS_REL_L2:
        raise AssertionError(f"fused paged decode logits: kernel vs plain rel L2 "
                             f"{out['logits_rel_l2']:.3g} > {LOGITS_REL_L2}")
    if out["argmax_kernel"] != out["argmax_plain"]:
        raise AssertionError(f"fused paged decode argmax {out['argmax_kernel']} (kernel) "
                             f"vs {out['argmax_plain']} (plain)")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def serve_phase(gpu: str) -> dict:
    """Phase 3: the serving CLI at full width."""
    from repro_torch.launch import serve

    before = read_counts()
    result = serve.main(SERVE_ARGS)
    after = read_counts()
    launched = {k: after[k] - before[k] for k in after}
    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    gen = int(SERVE_ARGS[SERVE_ARGS.index("--gen-len") + 1])
    if result["target"] != "h100":
        raise AssertionError(f"served with target {result['target']!r}")
    if result["requests"] != n_req or result["refused"]:
        raise AssertionError(f"{result['requests']} of {n_req} answered, "
                             f"refused {result['refused']}")
    short = {r: n for r, n in result["tokens_per_request"].items() if n != gen}
    if short or len(result["tokens_per_request"]) != n_req:
        raise AssertionError(f"requests without {gen} tokens: {short}")
    if result["padded_slot_steps_steady"] != 0:
        raise AssertionError(f"padded_slot_steps_steady "
                             f"{result['padded_slot_steps_steady']}")
    for name in ("rmsnorm", "swiglu"):
        if launched[name] <= 0:
            raise AssertionError(f"{name} kernel never launched while serving")
    print(f"[phase3] serve {ARCH} on {gpu}: decode_tokens_per_s "
          f"{result['decode_tokens_per_s']:.1f}, ttft_s_mean {result['ttft_s_mean']:.3f}, "
          f"launches while serving {launched}", flush=True)
    return {**result, "launches": launched}


def paged_requests(vocab: int, request_cls) -> list:
    import numpy as np

    rng = np.random.default_rng(5)
    system = rng.integers(0, vocab, PAGED_SYSTEM)
    return [request_cls(rid=f"p{i}", gen_len=PAGED_GEN, shared_prefix_len=PAGED_SYSTEM,
                        tokens=np.concatenate([system, rng.integers(0, vocab, PAGED_UNIQUE)])
                        .astype(np.int32))
            for i in range(PAGED_REQUESTS)]


def paged_serve_phase(dev, params, gpu: str) -> dict:
    """Phase 3b: fused paged serving at full width; the counters are set to
    0 just before the paged run and read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    cfg = get_config(ARCH)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK)
    engine = ServeEngine(cfg, paged=PagedConfig(page_size=PAGE), **kw)
    for fn in counters().values():
        fn.launches = 0
    report = engine.run(paged_requests(cfg.vocab, Request))
    launched = read_counts()
    paged = report["paged"]
    problems = []
    if report["target"] != "h100":
        problems.append(f"served with target {report['target']!r}")
    if not paged["fused"] or paged["lane_activations"]:
        problems.append(f"fused {paged['fused']}, lane_activations "
                        f"{paged['lane_activations']}")
    if paged["prefix_hits"] <= 0:
        problems.append("no prefix hit")
    if report["refused"] or report["requests"] != PAGED_REQUESTS:
        problems.append(f"{report['requests']} of {PAGED_REQUESTS} answered, refused "
                        f"{report['refused']}")
    short = {r: len(t) for r, t in report["outputs"].items() if len(t) != PAGED_GEN}
    if short or len(report["outputs"]) != PAGED_REQUESTS:
        problems.append(f"requests without {PAGED_GEN} tokens: {short}")
    if launched["paged_attention"] != cfg.n_layers * paged["decode_steps"]:
        problems.append(f"paged kernel launched {launched['paged_attention']} times in "
                        f"{paged['decode_steps']} decode steps of {cfg.n_layers} layers")
    for name in ("rmsnorm", "swiglu"):
        if launched[name] <= 0:
            problems.append(f"{name} kernel never launched while serving paged")
    if problems:
        raise AssertionError("paged serve: " + "; ".join(problems))
    # information, not a bar: the same requests through the lane-mode engine
    lane = ServeEngine(cfg, **kw).run(paged_requests(cfg.vocab, Request))
    same = sum(report["outputs"][r] == lane["outputs"][r] for r in report["outputs"])
    # where a request's tokens first differ from lane mode's (a kernel fault
    # would show at the first decoded tokens, a near-tied argmax anywhere)
    first_diff = sorted(next(i for i, (a, b) in enumerate(zip(toks, lane["outputs"][r]))
                             if a != b)
                        for r, toks in report["outputs"].items()
                        if toks != lane["outputs"][r])
    out = {"decode_tokens_per_s": report["decode_tokens_per_s"],
           "ttft_s_mean": report["ttft_s_mean"], "wall_s": report["wall_s"],
           "steps": report["steps"], "launches": launched, "paged": paged,
           "prefill_tokens": report["prefill_tokens"],
           "lane_decode_tokens_per_s": lane["decode_tokens_per_s"],
           "lane_ttft_s_mean": lane["ttft_s_mean"],
           "lane_prefill_tokens": lane["prefill_tokens"],
           "share_equal_to_lane": same / PAGED_REQUESTS,
           "first_differing_token": first_diff}
    print(f"[phase3b] paged serve {ARCH} on {gpu}: decode_tokens_per_s "
          f"{out['decode_tokens_per_s']:.1f}, ttft_s_mean {out['ttft_s_mean']:.3f}, "
          f"prefill_tokens {out['prefill_tokens']}, launches {launched}, paged "
          f"{json.dumps(paged)}; lane-mode run on the same requests "
          f"{out['lane_decode_tokens_per_s']:.1f} tokens/s, ttft "
          f"{out['lane_ttft_s_mean']:.3f} s, prefill_tokens {out['lane_prefill_tokens']}, "
          f"requests with equal tokens "
          f"{same}/{PAGED_REQUESTS}, first differing token of the others {first_diff}",
          flush=True)
    return out


def app_phase(dev, gpu: str) -> dict:
    """The paper's range-count app on the card: quickstart.main (the entry
    point a user runs) on each APP_CASES data set and range, whose four
    ways must give equal counts; the fused count of a prefix held against
    the torch_cpu library's on the host; each way timed by CUDA events
    (GiB/s of data against the 3.35 TB/s datasheet rate: Fig 10's generated
    vs hand-written, no claim) and the composed way's peak memory."""
    import torch

    from repro_torch import tsl_api
    from repro_torch.launch import quickstart

    ops = tsl_api.ops(dev)
    host_ops = tsl_api.ops("cpu")
    out = []
    for dtype, n, ranges in APP_CASES:
        data = quickstart.make_data(n, dtype, dev, seed=0)
        gib = data.numel() * data.element_size() / 2**30
        for lo, hi in ranges:
            result = quickstart.main(["--device", "cuda", "--n", str(n), "--dtype", dtype,
                                      "--low", str(lo), "--high", str(hi), "--seed", "0"])
            counts = result["counts"]
            prefix = data[:APP_CHECK_N]
            on_card = int(ops.range_count(prefix, lo, hi))
            on_host = int(host_ops.range_count(prefix.cpu(), lo, hi))
            if on_card != on_host:
                raise AssertionError(f"app {dtype} [{lo}, {hi}]: card count {on_card} of "
                                     f"the first {APP_CHECK_N} != host count {on_host}")
            if len(set(counts.values())) != 1:
                raise AssertionError(f"app {dtype} [{lo}, {hi}]: {counts}")
            times = {}
            for name, fn in quickstart.routes(ops).items():
                times[name] = cuda_ms(lambda: fn(data, lo, hi), 5)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            quickstart.composed(ops, data, lo, hi)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            row = {"dtype": dtype, "n": n, "low": lo, "high": hi,
                   "count": counts["fused"], "counts": counts, "prefix_count": on_card,
                   "ms": times,
                   "gib_per_s": {k: gib / (t / 1e3) for k, t in times.items()},
                   "share_of_3_35_tb_s": {k: n * data.element_size() / (t / 1e3) / 3.35e12
                                          for k, t in times.items()},
                   "composed_peak_gib_beyond_data": peak}
            print(f"[app] {dtype} n={n} [{lo}, {hi}] on {gpu}: {json.dumps(row)}",
                  flush=True)
            out.append(row)
        del data
        torch.cuda.empty_cache()
    return {"cases": out}


def suite_phase(gpu: str) -> dict:
    """The h100 library generated with its tests (paper §4.1), every
    generated test function run on the card in the file's (topological)
    order. Any failure fails the phase, after all have run."""
    import warnings

    from repro_torch.core import GenConfig, generate_library, load_library

    pkg_dir, _ = generate_library(GenConfig(target="h100"))
    lib = load_library("h100")
    if Path(lib.__file__).parent != pkg_dir:
        raise AssertionError(f"loaded {lib.__file__}, generated {pkg_dir}")
    mod = importlib.import_module(lib.__name__ + ".tests.test_generated")
    names = [n for n in vars(mod) if n.startswith("test_")]     # file order
    failed = {}
    t0 = time.perf_counter()
    for name in names:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # "unsafe test" warnings
                getattr(mod, name)()
        except Exception as e:  # noqa: BLE001 - counted, then raised below
            failed[name] = f"{type(e).__name__}: {e}"[:300]
    out = {"package": lib.__name__, "tests": len(names), "passed": len(names) - len(failed),
           "failed": len(failed), "seconds": time.perf_counter() - t0}
    print(f"[suite] generated h100 tests on {gpu}: {json.dumps(out)}", flush=True)
    if failed or not names:
        raise AssertionError(f"generated h100 suite: {len(failed)} of {len(names)} "
                             f"failed: {json.dumps(failed)[:3000]}")
    return out


def _host_top_functions(fn, n: int = 10) -> dict:
    """Host time by Python function over PROFILE_STEPS calls, ms per call:
    the top ``n`` by cProfile self time and by cumulative time (where a
    host-bound step spends its wall)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(PROFILE_STEPS):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats

    def top(col):
        rows = sorted(stats.items(), key=lambda kv: -kv[1][col])[:n]
        return {f"{Path(file).name}:{line}({name}) x{v[1] / PROFILE_STEPS:g}":
                v[col] * 1e3 / PROFILE_STEPS for (file, line, name), v in rows}

    return {"self": top(2), "cumulative": top(3)}


def _profile(fn) -> dict:
    """Host wall per call (synchronised), host time by Python function and,
    from one profiled window of PROFILE_STEPS calls, device busy time,
    kernel launches and top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, float] = {}       # kernel name (first 80 chars) -> us
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "launches": len(kernels) / PROFILE_STEPS,
           "host_top_functions_ms": _host_top_functions(fn)}
    if busy_us > 0:
        out["device_busy_ms"] = busy_us / 1e3 / PROFILE_STEPS
        out["device_idle_share"] = 1.0 - out["device_busy_ms"] / wall_ms
        out["top_kernels_ms"] = {name: t / 1e3 / PROFILE_STEPS for name, t in top}
    else:
        out["device_busy_ms"] = "not measured (the profiler recorded no device time)"
    return out


def profile_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4: where the time of one serving step goes, per step kind."""
    import torch

    cfg = model.cfg
    max_len = PROFILE_FILL + PROFILE_GEN          # the engine's slot-table length
    g = torch.Generator(device=dev).manual_seed(2)
    state = model.init_decode_state(PROFILE_BATCH, max_len)
    donor = model.init_decode_state(1, max_len)
    tokens = torch.randint(0, cfg.vocab, (PROFILE_BATCH, 1), generator=g, device=dev)
    chunk = torch.randint(0, cfg.vocab, (1, PROFILE_CHUNK), generator=g, device=dev)
    pos = torch.full((PROFILE_BATCH,), PROFILE_FILL, dtype=torch.int64)
    start = PROFILE_FILL - PROFILE_CHUNK
    with torch.inference_mode():
        pools, tables = paged_pools(dev, model, params, PROFILE_BATCH, PROFILE_FILL,
                                    seed=6)
        pos_dev = pos.to(dev)
        out = {
            "decode_step": {"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                            "max_len": max_len,
                            **_profile(lambda: model.decode_step(params, state,
                                                                 tokens, pos))},
            "decode_step_paged": {"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                                  "page": PAGE, "table_width": tables.shape[1],
                                  **_profile(lambda: model.decode_step_paged(
                                      params, {}, pools, tables, tokens, pos_dev))},
            "prefill_chunk": {"chunk": PROFILE_CHUNK, "pos": start,
                              **_profile(lambda: model.prefill_chunk(params, donor,
                                                                     chunk, start))},
        }
    for kind, r in out.items():
        print(f"[phase4] {kind} on {gpu}: {json.dumps(r)}", flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    dev = resolve_device("cuda")

    kernels = kernel_phase(dev)
    for fn in counters().values():
        fn.launches = 0
    model, lm, params = model_phase(dev, gpu)
    serve = serve_phase(gpu)
    counts = read_counts()
    paged = paged_serve_phase(dev, params, gpu)
    for fn in counters().values():
        fn.launches = 0
    app = app_phase(dev, gpu)
    app["launches"] = read_counts()
    for fn in counters().values():
        fn.launches = 0
    suite = suite_phase(gpu)
    suite["launches"] = read_counts()
    path_of = {"paged_attention": paged["launches"], "range_count": app["launches"],
               "hadd": app["launches"], "to_integral": app["launches"],
               "softmax": suite["launches"]}
    for row in kernels:
        row["launches"] = path_of.get(row["name"], counts)[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on its main path")
    profile_phase(dev, lm, params, gpu)
    print(f"[done] main-path launches {counts}, paged path {paged['launches']}, app "
          f"{app['launches']}, generated suite {suite['launches']} "
          f"({suite['passed']}/{suite['tests']} passed); per prefill "
          f"{model['prefill_launches']}, per decode step {model['decode_step_launches']}, "
          f"per prefill chunk {model['prefill_chunk_launches']}; "
          f"serve decode_tokens_per_s {serve['decode_tokens_per_s']:.1f} ttft_s_mean "
          f"{serve['ttft_s_mean']:.3f}, paged serve decode_tokens_per_s "
          f"{paged['decode_tokens_per_s']:.1f} ttft_s_mean {paged['ttft_s_mean']:.3f} "
          f"on {gpu}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
