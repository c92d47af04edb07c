"""Per-step continuous-batching serving engine with chunked prefill, lane
mode (mirrors ``repro/serve/engine.py`` without its paged, speculative and
mesh paths, which later slices of the port add).

One fixed-shape batched decode state (the slot table) runs ONE unified step
per iteration: every in-flight prefill advances by exactly one fixed-size
chunk (``prefill_chunk`` tokens into a batch-1 donor state), then one decode
step runs over every occupied slot. Long prompts therefore never stall token
generation for running slots.

Prompts are padded to UPD-declared length buckets before admission
(``BucketPolicy``), every bucket an exact multiple of the chunk size. Bucket
padding is exact: pad rows sit after every real row (causally invisible to
them), and the first token is sampled at the last REAL row, so chunked +
bucketed prefill gives the same tokens as whole-prompt prefill.

Requests may arrive on a trace: a preset ``arrival_s`` makes a request
visible to admission only once the engine clock reaches it; TTFT and SLA
accounting run from that arrival, and shared-step wall time is attributed
proportionally to prefill vs decode tokens.

The slot table, the donors and the KV caches are updated IN PLACE on the
device (the reference donates its buffers to jit for the same effect).

Report: per request TTFT, prefill_s/decode_s attribution, decode tokens/s,
latency, SLA hit, bucket; per run real-token throughput, steady-state padded
slot steps (0 == true continuous batching), TTFT percentiles by bucket,
slot reuse, the per-step log, the admission log, every refusal with its
reason, and the cost model's pricing. The reference's ``jit_cache`` key has
no counterpart: eager PyTorch compiles no step functions.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch.nn.model import build_model

from .scheduler import BucketPolicy, CostModelAdmission, Request, Scheduler
from .slots import validate_donor


@dataclass(frozen=True)
class SamplingConfig:
    """temperature <= 0 -> greedy argmax; top_k 0 -> no truncation."""

    temperature: float = 0.0
    top_k: int = 0


@dataclass
class _PrefillTask:
    """Host-side tracking of one request's chunk schedule.

    The in-flight prefill lives in a batch-1 DONOR state outside the slot
    table: the batched decode step runs over the FULL table every iteration,
    and a reserved slot's lane would be advanced with a garbage token between
    chunk steps. The donor is grafted into the slot once, at completion."""

    req: Request
    slot: int
    padded: np.ndarray          # (1, bucket) prompt padded to its bucket
    n_chunks: int
    donor: dict                 # batch-1 decode state being filled
    chunk_idx: int = 0
    fill: int = 0               # REAL rows in the donor's cache
    first_logits: torch.Tensor | None = None   # logits at the last real row
    prefill_s: float = 0.0


class ServeEngine:
    def __init__(self, cfg, *, batch: int, max_len: int,
                 sampling: SamplingConfig | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", target: str | None = None,
                 params: dict | None = None, admission: bool = True,
                 prefill_chunk: int | None = None,
                 buckets: tuple[int, ...] | None = None):
        """``params``: weights to serve (e.g. ``load_jax_params`` of the
        reference's); default ``model.init(seed)``. ``target`` overrides the
        library the device would select (``torch_cpu`` on the card runs the
        plain versions)."""
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.sampling = sampling or SamplingConfig()
        self.model = build_model(cfg, device=device, target=target)
        self.device = self.model.device
        self.params = params if params is not None else self.model.init(seed)
        # chunk size + admissible padded prompt lengths are UPD data; buckets
        # that cannot fit the slot table (bucket + 1 gen token) are dropped,
        # and an engine with none left falls back to the largest chunk
        # multiple that fits
        base = BucketPolicy.from_upd(chunk=prefill_chunk, buckets=buckets)
        chunk = base.chunk
        fit = tuple(b for b in base.buckets if b + 1 <= max_len)
        if not fit:
            largest = ((max_len - 1) // chunk) * chunk
            if largest < chunk:
                raise ValueError(
                    f"max_len={max_len} leaves no room for a single "
                    f"prefill chunk of {chunk}")
            fit = (largest,)
        self.policy = BucketPolicy(fit, chunk)
        self.cost_model = CostModelAdmission(
            cfg, batch, max_len, lib=self.model.lib,
            policy=self.policy) if admission else None
        # sampling draws come from a seeded device generator (the reference
        # draws from jax.random keys: sampled streams differ, greedy is exact)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # -- helpers --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        """Per-slot-temperature sampler over (B, V) logits: temp <= 0 rows
        take the argmax, the rest a Gumbel-max draw at their temperature
        (after top-k truncation). The lm head is padded_vocab wide: a padding
        id is never emitted."""
        masked = logits.float()
        masked[..., self.cfg.vocab:] = -1e30
        out = masked.argmax(-1)
        if (temps > 0).any():
            t = torch.as_tensor(temps, device=masked.device).clamp_min(1e-6)
            scaled = masked / t[:, None]
            if self.sampling.top_k:
                kth = scaled.topk(self.sampling.top_k, dim=-1).values[..., -1:]
                scaled = torch.where(scaled < kth, -1e30, scaled)
            u = torch.rand(scaled.shape, generator=self._gen, device=masked.device)
            drawn = (scaled - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(-1)
            use = torch.as_tensor(temps > 0, device=masked.device)
            out = torch.where(use, drawn, out)
        return out.cpu().numpy()

    def _slot_temperature(self, req: Request) -> float:
        return self.sampling.temperature if req.temperature is None \
            else float(req.temperature)

    def _chunk(self, task: _PrefillTask, seg: torch.Tensor, n_real: int):
        """One continuation-prefill chunk into the task's donor; returns the
        logits row at the chunk's last REAL token, (1, V)."""
        logits, task.donor = self.model.prefill_chunk(self.params, task.donor, seg,
                                                      task.fill)
        return logits[:, max(n_real, 1) - 1]

    # -- the serving loop -----------------------------------------------------

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> dict:
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request rids (outputs and metrics "
                             "are keyed by rid)")
        bad = [r.rid for r in requests if r.gen_len < 1]
        if bad:
            raise ValueError(f"gen_len must be >= 1 (requests {bad}); the "
                             "first token always comes from prefill")
        sched = Scheduler(self.batch, admission=self.cost_model)
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        for r in requests:
            sched.submit(r, now())

        state = self.model.init_decode_state(self.batch, self.max_len)
        axes = self.model.state_batch_axes(state)
        # host mirrors of per-slot decode-loop state: the pending token
        # (emitted but not yet consumed by the model), the cache fill and
        # the sampling temperature
        pending_host = np.zeros(self.batch, np.int64)
        pos_host = np.zeros(self.batch, np.int64)
        temps_host = np.full(self.batch, self.sampling.temperature, np.float32)
        outputs: dict[str, list[int]] = {}
        tasks: list[_PrefillTask] = []
        step_log: list[dict] = []
        step = 0
        padded_steady = 0
        generated = 0
        prefill_tokens_total = 0
        chunk = self.policy.chunk

        while sched.has_work() or tasks:
            t_step0 = time.perf_counter()
            sched.release(now())

            # -- reservation: every free slot starts a chunk schedule --------
            while True:
                free = sched.free_slots()
                if not free:
                    break
                req = sched.next_admissible(now())
                if req is None:
                    break
                bucket = req.bucket or self.policy.assign(req.prompt_len)
                if not bucket:
                    # admission off + prompt beyond the largest bucket: still
                    # cover the whole prompt in whole chunks
                    bucket = BucketPolicy.round_up(req.prompt_len, chunk)
                req.bucket = bucket
                padded = np.zeros((1, bucket), np.int64)
                padded[0, :req.prompt_len] = np.asarray(req.tokens, np.int64)
                tasks.append(_PrefillTask(
                    req=req, slot=free[0], padded=padded,
                    n_chunks=bucket // chunk,
                    donor=self.model.init_decode_state(1, self.max_len)))
                sched.reserve(free[0], req, step)

            # -- unified step, phase 1: one chunk per in-flight prefill ------
            ran: list[_PrefillTask] = []
            for task in tasks:
                c0 = task.chunk_idx * chunk
                seg = torch.as_tensor(task.padded[:, c0:c0 + chunk],
                                      device=self.device)
                n_real = max(0, min(task.req.prompt_len - c0, chunk))
                if task.fill + chunk > self.max_len:
                    raise RuntimeError(
                        f"prefill chunk for {task.req.rid!r} would overrun "
                        f"max_len={self.max_len} (admission off?)")
                last = self._chunk(task, seg, n_real)
                task.chunk_idx += 1
                ran.append(task)
                if n_real:
                    task.fill += n_real
                    task.first_logits = last
            chunk_tokens = len(ran) * chunk
            prefill_tokens_total += chunk_tokens

            active = sched.active_slots()
            if sched.queue:
                # released queue still has work: every free, unreserved slot
                # this step is waste (0 by construction with per-step
                # admission; a tripwire for future scheduling policies)
                padded_steady += self.batch - len(active) - len(tasks)

            # -- phase 2: one decode step over every occupied slot -----------
            emitted_this_step = 0
            if active:
                if int(pos_host[active].max()) >= self.max_len:
                    raise RuntimeError(
                        f"active slot position {int(pos_host[active].max())} "
                        f"overran max_len={self.max_len}")
                tokens = torch.as_tensor(pending_host[:, None], device=self.device)
                logits, state = self.model.decode_step(
                    self.params, state, tokens, torch.as_tensor(pos_host))
                toks = self._sample(logits, temps_host)
                for slot in active:
                    rid = sched.slots[slot].request.rid
                    sched.step_done(slot)
                    pos_host[slot] += 1
                    pending_host[slot] = int(toks[slot])
                    outputs[rid].append(int(toks[slot]))
                    generated += 1
                    emitted_this_step += 1

            # -- phase 3: shared-step time attribution (prefill vs decode) ---
            t_step = time.perf_counter() - t_step0
            pre_share, _ = sched.attribute_step_time(
                t_step, chunk_tokens, active, decode_tokens=emitted_this_step)
            for task in ran:
                task.prefill_s += pre_share / max(len(ran), 1)

            if ran or active:
                step_log.append({"step": step,
                                 "prefill_rids": [t.req.rid for t in ran],
                                 "chunks": len(ran),
                                 "decoded": len(active),
                                 "emitted": emitted_this_step})

            # -- phase 4: completions (finished prefills + finished decodes) -
            for task in list(tasks):
                if task.chunk_idx < task.n_chunks:
                    continue
                # prefill complete: graft the donor into its reserved slot,
                # sample the first token, occupy
                slot = task.slot
                temps_host[slot] = self._slot_temperature(task.req)
                first = int(self._sample(task.first_logits,
                                         temps_host[slot:slot + 1])[0])
                validate_donor(state, task.donor, axes)
                state = self.model.insert_slot(state, task.donor, slot)
                sched.place(task.req, slot)
                sched.add_prefill_time(slot, task.prefill_s)
                sched.first_token(slot, now())
                generated += 1
                outputs[task.req.rid] = [first]
                pending_host[slot] = first
                pos_host[slot] = task.fill
                tasks.remove(task)
                if sched.slot_done(slot):           # gen_len == 1 edge case
                    sched.finish(slot, now())
                    state = self.model.reset_slot(state, slot)
            for slot in list(active):
                if sched.slot_done(slot):
                    sched.finish(slot, now())
                    state = self.model.reset_slot(state, slot)

            if ran or active:
                step += 1           # a unified step actually did device work
            elif not sched.active_slots() and not tasks:
                nxt = sched.next_arrival_s()
                if nxt is not None and not sched.queue:
                    # idle until the next scheduled arrival
                    time.sleep(max(0.0, min(nxt - now(), 0.05)))

        wall = max(now(), 1e-9)
        finished = sched.finished
        ttfts = [m.ttft_s for m in finished]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        by_bucket: dict[int, list[float]] = {}
        for m in finished:
            by_bucket.setdefault(m.bucket, []).append(m.ttft_s)
        ttft_by_bucket = {
            b: {"n": len(xs), "p50_s": pct(xs, 50), "p90_s": pct(xs, 90),
                "p99_s": pct(xs, 99)}
            for b, xs in sorted(by_bucket.items())
        }

        report = {
            "arch": self.cfg.name,
            "device": str(self.device),
            "target": self.model.lib.TARGET_NAME,
            "requests": len(finished),
            "generated_tokens": generated,
            "decode_tokens_per_s": generated / wall,
            "steps": step,
            "wall_s": wall,
            "padded_slot_steps_steady": padded_steady,
            "prefill_chunk": chunk,
            "buckets": list(self.policy.buckets),
            "prefill_tokens": prefill_tokens_total,
            "ttft_s_mean": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_by_bucket": ttft_by_bucket,
            "sla_hit_rate": sched.sla_hit_rate(),
            "slot_reuse": sched.slot_reuse(),
            "admission_log": sched.admission_log,
            "step_log": step_log,
            "per_request": [asdict(m) for m in finished],
            "refused": [{"rid": r.rid, "reason": r.reason}
                        for r in sched.refused],
            "outputs": outputs,
        }
        if self.cost_model is not None:
            report["cost_model"] = {
                "decode_bytes_per_step": self.cost_model.decode_bytes_per_step(),
                "step_seconds": self.cost_model.step_seconds(),
                "prefill_seconds_largest_bucket":
                    self.cost_model.prefill_seconds(self.policy.buckets[-1]),
            }
        return report
