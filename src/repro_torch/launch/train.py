"""Training launcher (mirrors ``repro/launch/train.py``): the train loop with
checkpoint/restart and a straggler watchdog. Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 6 --batch 4 --seq 32 --moment-dtype int8

Restart semantics: on start, restore the newest committed checkpoint (params,
optimizer, data-pipeline state) and continue; a kill at any point loses at
most ``--ckpt-every`` steps. The checkpoints are the reference's format, so
either launcher continues the other's run. The schedule is
``OptConfig(total_steps=max(steps, 10), warmup_steps=max(steps // 10, 2))``,
as in the reference: a restart continues the same schedule only when it is
run with the same ``--steps`` (or two values that give the same pair).

The step is compiled where the reference jits it, after the restore:
``compile_train_step`` captures it in one CUDA graph at its first call on the
card and replays it after, over the donated train state (updated in place;
the first call adopts the restored state). Each batch from the prefetcher is
staged through the step (pinned, ``non_blocking``). Under
``repro_torch.graphs.disable_graphs()`` the loop runs the eager step, op by
op. Unlike the reference, the initial params are the port's own seeded init
(``init_train_state``), and ``--dp`` / ``--tp`` other than 1 raise: the
sharded engine is not ported yet (ROADMAP.md, queue 1, item 9). The vlm
and audio families are refused before anything is built: their batches need
vision or audio rows, which ``SyntheticTokens`` does not make. The dense and
hybrid (zamba) families train on its tokens and labels alone; rwkv and moe
training raise in ``make_train_step`` (queue 1, items 11 and 15). The
watchdog flags steps slower than ``factor`` x the running median; here it
logs and counts.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataState, Prefetcher, SyntheticTokens
from repro_torch.nn.model import build_model
from repro_torch.train.graphs import compile_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import init_train_state, make_train_step

SHARDED_TODO = "the sharded engine is not ported yet (ROADMAP.md, queue 1, item 9)"
# the train batch's embedding rows per family; SyntheticTokens yields tokens
# and labels only, and the reference's CLI fails on both families too
EMBEDS = {"vlm": "vision_embeds", "audio": "audio_embeds"}


class StepWatchdog:
    """Straggler mitigation, single-host flavor: detect slow steps, attribute
    them (data-starved vs compute), and surface counters for the controller."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.stragglers = 0
        self.data_starved = 0

    def observe(self, dt: float, queue_depth: int) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.stragglers += 1
                if queue_depth == 0:
                    self.data_starved += 1
                return True
        return False


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a Hopper card, the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moment-dtype", default="float32", choices=["float32", "int8"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if (args.dp, args.tp) != (1, 1):
        raise NotImplementedError(f"--dp {args.dp} --tp {args.tp}: {SHARDED_TODO}")

    cfg = get_config(args.arch)
    if cfg.family in EMBEDS:
        raise ValueError(f"--arch {args.arch}: a {cfg.family} train batch needs "
                         f"{EMBEDS[cfg.family]!r} rows, and SyntheticTokens carries no "
                         f"vision or audio rows (tokens and labels only): train this "
                         f"family through make_train_step with batches that hold them")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    dev = model.device
    opt_cfg = OptConfig(lr=args.lr, total_steps=max(args.steps, 10),
                        warmup_steps=max(args.steps // 10, 2),
                        moment_dtype=args.moment_dtype)
    train_step = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                                 compress_grads=args.compress_grads)
    state = init_train_state(model, opt_cfg, seed=args.seed)

    data_state = DataState()
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start_step, state, extra = restored
            data_state = DataState.from_dict(extra.get("data", {}))
            print(f"[train] restored checkpoint at step {start_step}")

    jstep = compile_train_step(train_step)
    source = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed)
    data_state.step = start_step
    prefetch = Prefetcher(source, data_state, depth=2)
    watchdog = StepWatchdog()
    save_s = 0.0                  # the loop thread's time in checkpoint saves

    def save(step: int, async_: bool):
        nonlocal save_s
        t0 = time.perf_counter()
        ckpt.save(step, state, extra={"data": data_state.as_dict()}, async_=async_)
        save_s += time.perf_counter() - t0

    losses = []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            state, metrics = jstep(state, prefetch.get())
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            if watchdog.observe(dt, prefetch.depth):
                print(f"[watchdog] step {step}: straggler ({dt:.2f}s, "
                      f"queue={prefetch.depth})")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} ({dt:.2f}s)")
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                save(step + 1, async_=True)
        if ckpt is not None:
            save(args.steps, async_=False)
    finally:
        prefetch.stop()

    wall = time.perf_counter() - t_start
    tokens = (args.steps - start_step) * args.batch * args.seq
    result = {
        "arch": cfg.name,
        "device": str(dev),
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "steps": args.steps,
        "tokens_per_s": tokens / wall,
        "stragglers": watchdog.stragglers,
        "ckpt_save_s": save_s,
    }
    print("[train] done:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
