"""Serving launcher: thin CLI over repro_torch.serve.ServeEngine (per-step
continuous batching with chunked prefill — prompts are padded to
UPD-declared length buckets, prefill advances one fixed-size chunk per
unified step alongside decode, admission is cost-model gated, and sampling
is configurable). Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 256 --gen-len 64 --requests 16 --prefill-chunk 64

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --device cpu --batch 4 --prompt-len 32 --gen-len 32
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serve import BucketPolicy, Request, SamplingConfig, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a Hopper card, the default) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-table size (decode batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = full distribution)")
    ap.add_argument("--sla-ms", type=float, default=None,
                    help="per-request end-to-end deadline; feeds both "
                         "cost-model admission and the hit-rate report")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill tokens per unified step (default: the "
                         "UPD-declared serve chunk; declared buckets round "
                         "up to whole chunks)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    # budget the slot table for the length bucket the prompt pads to, or
    # admission would refuse every request by construction; a prompt beyond
    # the largest declared bucket extends the bucket set instead of refusing
    policy = BucketPolicy.from_upd(chunk=args.prefill_chunk)
    bucket = policy.assign(args.prompt_len)
    buckets = None
    if bucket is None:
        bucket = BucketPolicy.round_up(args.prompt_len, policy.chunk)
        buckets = policy.buckets + (bucket,)
    engine = ServeEngine(
        cfg, batch=args.batch,
        max_len=bucket + args.gen_len,
        sampling=SamplingConfig(temperature=args.temperature, top_k=args.top_k),
        seed=args.seed, device=args.device,
        prefill_chunk=args.prefill_chunk, buckets=buckets)

    rng = np.random.default_rng(args.seed)
    sla_s = args.sla_ms / 1e3 if args.sla_ms is not None else None
    requests = [
        Request(rid=f"req{i}",
                tokens=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                gen_len=args.gen_len, sla_s=sla_s)
        for i in range(args.requests)
    ]

    report = engine.run(requests)
    first = report["outputs"].get("req0", [])
    result = {
        "arch": cfg.name,
        "device": report["device"],
        "target": report["target"],
        "requests": report["requests"],
        "generated_tokens": report["generated_tokens"],
        "tokens_per_request": {rid: len(toks) for rid, toks in report["outputs"].items()},
        "decode_tokens_per_s": report["decode_tokens_per_s"],
        "ttft_s_mean": report["ttft_s_mean"],
        "sla_hit_rate": report["sla_hit_rate"],
        "padded_slot_steps_steady": report["padded_slot_steps_steady"],
        "prefill_chunk": report["prefill_chunk"],
        "buckets": report["buckets"],
        "ttft_by_bucket": report["ttft_by_bucket"],
        "refused": report["refused"],
        "sample_output": first[:8],
    }
    print("[serve] done:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
