#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py          # from the repo root, one card, no arguments

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Kernels. Builds every kernel of the main paths from the sources in the
   checkout (nvcc for the CUDA C++ flash and paged attention, both started
   at once; Triton JIT for rmsnorm and swiglu), runs each wrapper on the
   card at the main paths' shapes and holds it against its plain PyTorch
   version on the same inputs within the stated tolerance; times kernel,
   plain version and the one PyTorch library call that computes the same
   function (a yardstick only: the port never calls it) with CUDA events,
   and computes each case's bound from the bytes and operations its inputs
   need against the H100 SXM datasheet peaks. No single PyTorch call
   computes paged attention: its yardstick is scaled_dot_product_attention
   on the same rows already gathered into contiguous lanes (gather not
   timed). For the paged serving shape it also times the host's enqueue of
   one call: wrapper, bare launcher and the yardstick.
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
(paged attention, rmsnorm and swiglu). Launches made to compare a kernel
with its plain version are not counted.

Stdout ends with the card's name and power limit (nvidia-smi), one JSON line
{"kernels": [...]}, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks (dense): the roofline the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output may differ
# by one rounding step (2^-7 relative) where the f32 sums round differently;
# f32 differs only by summation order
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


def check_case(name, shape, got, want, dtype) -> dict:
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    atol, rtol = TOLERANCE[str(dtype)]
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
    from repro_torch.kernels.paged import kernel as pa_kernel
    from repro_torch.kernels.paged import ops as pa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.swiglu import ops as sw

    t0 = time.perf_counter()
    # nvcc builds of the CUDA sources (cached by digest), one per source, at once
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda build: build(), (fa_kernel._fn, pa_kernel._fn)))
    print(f"[phase1] flash_attention and paged_attention built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("flash_attention", "paged_attention"):
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
            print(f"[phase1] {name} {c['shape']} {c['dtype']}: err {c['max_abs_err']:.3g} "
                  f"(rel {c['max_rel_err']:.3g}, {c['tolerance_used']:.2f} of tolerance) "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"library {c['library_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})"
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


def counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.swiglu.ops import swiglu

    return {"rmsnorm": rmsnorm, "swiglu": swiglu, "flash_attention": flash_attention,
            "paged_attention": paged_attention}


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
    for row in kernels:
        path = paged["launches"] if row["name"] == "paged_attention" else counts
        row["launches"] = path[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on its main path")
    profile_phase(dev, lm, params, gpu)
    print(f"[done] main-path launches {counts}, paged path {paged['launches']}; per prefill "
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
