"""Per-step continuous-batching serving engine with chunked prefill, in lane
mode or over paged slot memory, with speculative decoding (mirrors
``repro/serve/engine.py`` without its mesh path, which the sharded engine
adds).

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
proportionally to prefill vs decode tokens. ``submit()`` hands a request to a
RUNNING ``run()`` from another thread: the loop drains its inbox at the top
of every step, and a duplicate rid or ``gen_len < 1`` among submitted
requests becomes a recorded refusal instead of an error.

The slot table, the donors and the KV caches are updated IN PLACE on the
device (the reference donates its buffers to jit for the same effect).

The device steps are compiled as the reference jits them
(``serve/graphs.py``): on the card the decode step, each verify span width
and the prefill chunk are captured in CUDA graphs at first use and replayed
after, in lane and fused paged mode alike; the sampler, slot insert and
reset, and the page bookkeeping stay eager. The slot table is allocated once
per engine (zeroed at each run) so the graphs keep pointing at it, and every
prefill chunk runs through one staging donor. ``graphs.disable_graphs()``
runs every step eagerly, op by op.

Paged mode (``paged=PagedConfig(...)``): admission and residency are PAGE
decisions (``serve/paging.py``). Prefills run lane-less into donors (up to
``max_inflight_prefills`` at once) and commit their rows into pages at
completion; a completed request with no free lane PARKS in its pages and
activates when a lane frees. Identical prompt prefixes are prefilled once
and shared copy-on-write; decode growth past the pool preempts the
latest-activated request into a continuation at the queue head; cold parked
pages spill to host memory. FUSED (the default) decodes every slot straight
off the pools through per-step (B, P) block tables
(``Model.decode_step_paged`` -> ``attention_decode_paged``, the CUDA C++
block-table kernel on the card) — no page->lane gather ever runs;
``fused=False`` activates a request by gathering its pages into a lane and
decodes as lane mode (the bit-identical fallback). ``PagedConfig(int8=True)``
keeps the pages as absmax int8 with a float32 scale per row: the fused steps
quantize each written row into the pools and dequantize per touched page in
the plain paged attention (the reference runs no Pallas kernel on int8 pools
either), and a lane activation dequantizes on its gather.

Speculative decoding (``speculation=SpeculationConfig(...)``, ``serve/spec.py``)
makes phase 2 a decode OR a verify step: a drafter proposes up to k tokens per
slot, ONE batched ragged verify step (``Model.verify_step``, or
``verify_step_paged`` -> ``attention_verify_paged``, the same CUDA C++
block-table kernel on the card) scores every slot's span at its own position,
and each slot emits its longest accepted prefix plus one corrected token.
Depth is per slot and per step (``SpeculationPolicy``), and a step where every
depth is 0 is exactly the plain decode step: the same call, the same sampler
draw. The slot table, the donors and the block tables carry ``k_max`` rows of
headroom past ``max_len`` for the span rows of slots whose own window is
smaller than the step's widest.

Report: per request TTFT, prefill_s/decode_s attribution, decode tokens/s,
latency, SLA hit, bucket; per run real-token throughput, steady-state padded
slot steps (0 == true continuous batching), TTFT percentiles by bucket,
slot reuse, the per-step log, the admission log, every refusal with its
reason, the cost model's pricing, in paged mode ``report["paged"]`` and, with
speculation on, ``report["spec"]`` (accepted rate, mean accepted span, steps
per emitted token, split by bucket). Only target-emitted tokens count as
output: rejected drafts never do. ``report["jit_cache"]`` counts the compiled
entries per step kind with the reference's keys: ``prefill_chunk``,
``decode`` (the lane or the fused paged step) and, with speculation on,
``verify`` (one per span width) and, for a family with a commit (rwkv,
zamba), ``commit`` (one per span width) and, fused paged for a family with
a paged commit (zamba), ``commit_paged`` (one per span width).

Recurrent families (rwkv, zamba): every prefill chunk carries its count of
real rows (``n_real``, a staged device tensor), and padding rows leave the
recurrent state exactly as it was. Their verify step leaves that state as
it was; after acceptance the commit step replays each slot's accepted
prefix into the slot table (``Model.verify_commit``, ``n_commit`` =
accepted drafts + 1 for an active slot, 0 for an idle one). Nothing of
rwkv's state pages, so paged mode serves it from lanes: prefills park and
activate through the store's tail snapshots, prefixes are shared as the
tail at the boundary, and ``report["paged"]["fused"]`` is false. zamba's
state has both kinds (the shared attention's KV caches page, the Mamba2
tails do not): fused paged mode keeps the tails in the slot table and the
KV in the pools, a prefill completes into pages plus a tail snapshot, a
prefix entry holds the shared pages and the tail at its boundary (restored
by copy), and the commit replays on the pools
(``Model.verify_commit_paged``), as the reference does.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch.nn.model import build_model

from .graphs import StepGraphs, run_commit, run_model_step, run_prefill_chunk
from .paging import PagedConfig, PagedKVStore, prefix_key, selected_page_size
from .scheduler import (BucketPolicy, CostModelAdmission, PagedAdmission, Refusal,
                        Request, Scheduler)
from .slots import PagesExhausted, assert_span_fits, validate_donor
from .spec import SpeculationConfig, SpeculationPolicy, accept_span, build_drafter, \
    upd_verify_defaults


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
    fill: int = 0               # REAL rows in the donor's cache (incl. prefix)
    first_logits: torch.Tensor | None = None   # logits at the last real row
    prefill_s: float = 0.0
    # paged mode (slot == -1: no lane is reserved; the request activates
    # into a free lane at completion or parks resident in pages)
    share_key: str | None = None    # prefix-store content address
    share_rows: int = 0             # aligned share-boundary cache rows
    publish: bool = False           # miss: this task publishes the prefix
    boundary_tail: dict | None = None   # tail snapshot AT the boundary


class ServeEngine:
    def __init__(self, cfg, *, batch: int, max_len: int,
                 sampling: SamplingConfig | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", target: str | None = None,
                 params: dict | None = None, admission: bool = True,
                 prefill_chunk: int | None = None,
                 buckets: tuple[int, ...] | None = None,
                 paged: PagedConfig | None = None,
                 speculation: SpeculationConfig | None = None,
                 draft_params: dict | None = None):
        """``params``: weights to serve (e.g. ``load_jax_params`` of the
        reference's); default ``model.init(seed)``. ``target`` overrides the
        library the device would select (``torch_cpu`` on the card runs the
        plain versions). ``paged`` switches on paged slot memory,
        ``speculation`` speculative decoding. ``draft_params``: the weights
        of a ``draft_model`` drafter; default its ``init(seed + 2)``."""
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
        # -- speculative depth (before the paged store: every state carries
        # k_max rows of headroom). A verify span writes K+1 rows at each
        # slot's fill, K the step's widest depth; a slot whose own window is
        # smaller takes its neighbours' depth, so rows past max_len hold only
        # drafts that are never committed
        self.spec = speculation
        self._k_max = 0
        if speculation is not None:
            self._k_max = speculation.k_max if speculation.k_max is not None \
                else upd_verify_defaults()["k_max"]
        self._state_len = max_len + self._k_max
        # -- paged slot memory (block-table residency under the lanes) -------
        self.paged = paged
        self._store: PagedKVStore | None = None
        self._seed = seed
        self._max_inflight = 0
        self._parked: dict[str, dict] = {}      # rid -> resume info (FIFO)
        self._resumed: dict[str, dict] = {}     # rid -> preemption stash
        self._inflight_keys: dict[str, str] = {}  # share key -> publisher rid
        self._act_stamp: dict[int, int] = {}    # slot -> activation seq
        self._act_seq = 0
        self._preempt_count = 0
        if paged is not None:
            donor = self.model.init_decode_state(1, self._state_len)
            shapes = {n: (tuple(t.shape), t.dtype) for n, t in donor.items()}
            self._page_axes = self.model.state_page_axes(donor)
            psize = paged.page_size or selected_page_size(self.model.tsl)
            n_pages = None
            if paged.hbm_budget_bytes is None:
                # default budget: pages for 2x the lane count at worst-case
                # length — paged strictly dominates the contiguous table
                probe = PagedKVStore(shapes, self._page_axes, page_size=psize,
                                     ops=self.model.tsl, n_pages=1, int8=paged.int8,
                                     device="meta")
                n_pages = 2 * batch * max(probe.pages_for_rows(max_len), 1)
            # a family without the fused paged contract (rwkv: nothing
            # pages) gets a flat store and activates into lanes
            self._store = PagedKVStore(
                shapes, self._page_axes, page_size=psize,
                hbm_budget_bytes=paged.hbm_budget_bytes, n_pages=n_pages,
                int8=paged.int8, fused=paged.fused and self.model.decode_step_paged is not None,
                device=self.device, ops=self.model.tsl)
            self._max_inflight = paged.max_inflight_prefills or 2 * batch
        # FUSED paged decode: slots decode straight off the block-table pools
        self._fused = self._store is not None and self._store.fused
        self._table_width = -(-self._state_len // self._store.page) if self._fused else 0
        self._lane_activations = 0      # full page->lane gathers (fallback)
        self._tail_restores = 0         # fused activations (tails only)
        self._gather_bytes_eliminated = 0
        if not admission:
            self.cost_model = None
        elif self._store is not None:
            self.cost_model = PagedAdmission(cfg, batch, max_len, lib=self.model.lib,
                                             budget=self._store, policy=self.policy)
        else:
            self.cost_model = CostModelAdmission(cfg, batch, max_len, lib=self.model.lib,
                                                 policy=self.policy)
        # -- speculative decoding (draft / verify over the slot table) -------
        self._drafter = None
        self._spec_policy = None
        if speculation is not None:
            self._drafter = build_drafter(speculation, cfg, batch=batch,
                                          state_len=self._state_len, seed=seed + 2,
                                          device=self.device, target=target,
                                          params=draft_params)
            pricing = self.cost_model or CostModelAdmission(
                cfg, batch, max_len, lib=self.model.lib, policy=self.policy)
            if self.cost_model is not None:
                self.cost_model.spec_k = self._k_max
            self._spec_policy = SpeculationPolicy(
                batch, self._k_max, pricing, speculation,
                drafter_cost_s=self._drafter.cost_per_token_s())
        # sampling draws come from a seeded device generator (the reference
        # draws from jax.random keys: sampled streams differ, greedy is exact)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # the compiled steps, and the slot table they point at
        self._graphs = StepGraphs(self.device)
        self._state: dict | None = None
        # requests handed to a running loop (submit): any thread appends, the
        # loop alone pops (list append and pop are atomic under the GIL)
        self._inbox: list[Request] = []

    # -- helpers --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        """Per-slot-temperature sampler over (B, V) logits, or (B, SV, V) for
        a verify span (every span row at its slot's temperature): temp <= 0
        rows take the argmax, the rest a Gumbel-max draw at their temperature
        (after top-k truncation). The lm head is padded_vocab wide: a padding
        id is never emitted."""
        masked = logits.float()
        masked[..., self.cfg.vocab:] = -1e30
        out = masked.argmax(-1)
        if (temps > 0).any():
            lead = (masked.shape[0],) + (1,) * (masked.ndim - 2)
            t = torch.as_tensor(temps, device=masked.device).clamp_min(1e-6)
            scaled = masked / t.view(lead + (1,))
            if self.sampling.top_k:
                kth = scaled.topk(self.sampling.top_k, dim=-1).values[..., -1:]
                scaled = torch.where(scaled < kth, -1e30, scaled)
            u = torch.rand(scaled.shape, generator=self._gen, device=masked.device)
            drawn = (scaled - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(-1)
            use = torch.as_tensor(temps > 0, device=masked.device).view(lead)
            out = torch.where(use, drawn, out)
        return out.cpu().numpy()

    def _slot_temperature(self, req: Request) -> float:
        return self.sampling.temperature if req.temperature is None \
            else float(req.temperature)

    def _chunk(self, task: _PrefillTask, seg: np.ndarray, n_real: int):
        """One continuation-prefill chunk into the task's donor; returns a
        copy of the logits row at the chunk's last REAL token, (1, V) (the
        step's logits are overwritten by the next step)."""
        logits = run_prefill_chunk(self._graphs, self.model, self.params, task.donor, seg,
                                   task.fill, n_real)
        return logits[:, max(n_real, 1) - 1].clone()

    def _step_kinds(self) -> tuple:
        """The compiled step kinds this engine reports (``jit_cache``)."""
        if self.spec is None:
            return ("prefill_chunk", "decode")
        commit = ("commit",) if self.model.verify_commit is not None else ()
        if self._fused and self.model.verify_commit_paged is not None:
            commit += ("commit_paged",)
        return ("prefill_chunk", "decode", "verify") + commit

    def _new_donor(self) -> dict:
        return self.model.init_decode_state(1, self._state_len)

    def _init_state(self) -> dict:
        """The slot table, allocated at the first run and zeroed at every
        later one: the compiled steps keep pointing at it."""
        if self._state is not None:
            for t in self._state.values():
                t.zero_()
            return self._state
        # _state_len = max_len + k_max: the verify span's headroom rows;
        # admission and the overrun guards still cap real fill at max_len
        state = self.model.init_decode_state(self.batch, self._state_len)
        if self._fused:
            # fused mode keeps only the TAIL leaves in the slot table (none
            # for the dense family): the paged leaves live in the pools
            state = {n: state[n] for n, ax in self._page_axes.items() if ax is None}
        self._state = state
        return state

    def _tails_template(self) -> dict:
        """Zeroed tails-only donor for fused activation: load_donor restores
        the tail snapshot into it and, lacking the paged leaves, gathers no
        page."""
        return {n: torch.zeros(shape, dtype=dt, device=self.device)
                for n, (shape, dt) in self._store.tail_leaves.items()}

    def _build_tables(self, sched: Scheduler, active) -> np.ndarray:
        """(B, P) int32 block table for this step: active slots' page lists
        (scratch-padded past coverage), all-scratch rows for idle slots —
        every entry is a valid page id."""
        tabs = np.full((self.batch, self._table_width), self._store.scratch_page,
                       np.int32)
        for slot in active:
            tabs[slot] = self._store.table_row(sched.slots[slot].request.rid,
                                               self._table_width)
        return tabs

    # -- paged serving helpers ------------------------------------------------

    def _share_plan(self, req: Request) -> tuple[str | None, int]:
        """(content key, boundary rows) for the shareable prefix of ``req``,
        or (None, 0). The boundary is the largest chunk-aligned token count
        <= the caller's shared_prefix_len hint (default: the whole prompt
        minus its last token — the first token's logits must come from a
        re-run chunk) that is page-aligned: only whole pages are shared."""
        if self._store is None or not self.paged.prefix_sharing:
            return None, 0
        cap = req.prompt_len - 1 if req.shared_prefix_len is None \
            else min(int(req.shared_prefix_len), req.prompt_len - 1)
        chunk = self.policy.chunk
        t = (cap // chunk) * chunk
        if self._store.paged:
            while t >= chunk and t % self._store.page:
                t -= chunk
        if t < chunk:
            return None, 0
        key = prefix_key(arch=self.cfg.name, page_size=self._store.page,
                         int8=self._store.int8, seed=self._seed,
                         tokens=np.asarray(req.tokens, np.int64)[:t])
        return key, t

    def _reserve_paged(self, sched: Scheduler, tasks: list, now, step: int) -> None:
        """Paged reservation: admit up to max_inflight concurrent prefills,
        attach each to the store (prompt pages now, shared prefix retained on
        a hit) and fast-forward the chunk schedule past shared rows. A prompt
        whose prefix an in-flight publisher is still prefilling DEFERS until
        the entry is published: followers hit the store instead of racing
        the publisher (prefill-once)."""
        chunk = self.policy.chunk
        while len(tasks) < self._max_inflight:
            req = sched.next_admissible(now())
            if req is None:
                break
            share_key, share_rows = self._share_plan(req)
            if share_key is not None and share_key in self._inflight_keys:
                sched.requeue_front(req)
                break
            bucket = req.bucket or self.policy.assign(req.prompt_len)
            if not bucket:
                bucket = BucketPolicy.round_up(req.prompt_len, chunk)
            req.bucket = bucket
            try:
                shared = self._store.attach(req.rid, prompt_rows=req.prompt_len,
                                            share_key=share_key)
            except PagesExhausted:
                # admission saw enough pages, the attach lost the race:
                # transient, retry next step
                sched.requeue_front(req)
                break
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :req.prompt_len] = np.asarray(req.tokens, np.int64)
            task = _PrefillTask(req=req, slot=-1, padded=padded,
                                n_chunks=bucket // chunk, donor=self._new_donor(),
                                share_key=share_key, share_rows=share_rows)
            if shared:
                # prefix hit: seed the donor from the shared pages and skip
                # the chunks they cover — shared rows are never prefilled
                task.donor = self._store.load_donor(req.rid, task.donor)
                task.fill = shared
                task.chunk_idx = shared // chunk
            elif share_key is not None:
                task.publish = True
                self._inflight_keys[share_key] = req.rid
            sched.reserve_unplaced(req, step)
            tasks.append(task)

    def _occupy(self, sched, state, donor, slot, rid, info, pending_host, pos_host,
                temps_host, histories):
        """Graft ``donor`` into free lane ``slot`` and resume ``rid`` there."""
        validate_donor(state, donor, self.model.state_batch_axes(state))
        state = self.model.insert_slot(state, donor, slot)
        sched.place_parked(rid, slot)
        temps_host[slot] = info["temp"]
        pending_host[slot] = info["pending"]
        pos_host[slot] = info["fill"]
        histories[slot] = info["history"]
        self._act_seq += 1
        self._act_stamp[slot] = self._act_seq
        if self._spec_policy is not None:
            self._spec_policy.reset(slot)
            self._drafter.on_graft(rid, slot, histories[slot])
        return state

    def _activate_parked(self, sched: Scheduler, state, pending_host, pos_host,
                         temps_host, histories):
        """Drain parked (resident, lane-less) requests into free lanes, FIFO,
        resuming each at its committed fill. Fused: restore the tails only —
        the pages stay in the pools (the gather the lane path would run is
        counted as eliminated); fallback: gather the pages into a donor."""
        for slot in sched.free_slots():
            if not self._parked:
                break
            rid = next(iter(self._parked))
            info = self._parked.pop(rid)
            self._store.pin(rid)        # hot again: rehydrate, no spilling
            if self._fused:
                donor = self._store.load_donor(rid, self._tails_template())
                self._tail_restores += 1
                self._gather_bytes_eliminated += \
                    self._store.requests[rid].fill * self._store.fp_row_bytes
            else:
                donor = self._store.load_donor(rid, self._new_donor())
                self._lane_activations += 1
            state = self._occupy(sched, state, donor, slot, rid, info, pending_host,
                                 pos_host, temps_host, histories)
        return state

    def _preempt_slot(self, slot: int, sched: Scheduler, state, histories):
        """Page exhaustion: evict a decoding request from its lane, free its
        pages, and requeue a CONTINUATION at the queue head — prompt =
        everything the model has consumed, resume_token = the emitted but
        unconsumed pending token. Re-prefilling those rows reproduces the
        evicted cache (chunked prefill gives decode's tokens), so
        preemption is lossless."""
        req, m = sched.preempt(slot)
        rid = req.rid
        hist = histories.pop(slot)
        prev = self._resumed.get(rid)
        self._resumed[rid] = {
            # the original identity survives any number of preemptions
            "prompt_len": prev["prompt_len"] if prev else m.prompt_len,
            "bucket": prev["bucket"] if prev else m.bucket,
            "admitted_at_step": prev["admitted_at_step"] if prev else m.admitted_at_step,
            "gen_len": m.gen_len,
            "ttft_s": m.ttft_s,
            "tokens_out": m.tokens_out,
            "prefill_s": m.prefill_s,
            "decode_s": m.decode_s,
            "preemptions": m.preemptions + 1,
            "spec_proposed": m.spec_proposed,
            "spec_accepted": m.spec_accepted,
            "verify_rounds": m.verify_rounds,
        }
        self._preempt_count += 1
        sched.requeue_front(Request(
            rid=rid, tokens=np.asarray(hist[:-1], np.int64), gen_len=m.gen_len,
            sla_s=req.sla_s, arrival_s=req.arrival_s, temperature=req.temperature,
            shared_prefix_len=req.shared_prefix_len, resume_token=int(hist[-1])))
        self._store.free(rid)
        self._act_stamp.pop(slot, None)
        if self._drafter is not None:
            self._drafter.on_finish(slot)
        return self.model.reset_slot(state, slot)

    def _grow_or_preempt(self, active, k_vec, sched: Scheduler, state, pos_host,
                         histories):
        """Before phase 2: every decoding slot's pages must cover the rows
        this step may commit (pos + depth + 1, capped at max_len: span rows
        past it only ever hold drafts that are never committed). On
        exhaustion, preempt the LATEST-activated slot (it has sunk the least
        decode work) until the grow fits — possibly the growing slot
        itself."""
        active = list(active)
        for slot in list(active):
            if slot not in active:
                continue
            rid = sched.slots[slot].request.rid
            need = min(int(pos_host[slot]) + int(k_vec[slot]) + 1, self.max_len)
            while True:
                try:
                    self._store.grow(rid, need)
                    break
                except PagesExhausted:
                    victims = [s for s in active if s != slot] or [slot]
                    victim = max(victims, key=lambda s: self._act_stamp.get(s, -1))
                    state = self._preempt_slot(victim, sched, state, histories)
                    active.remove(victim)
                    k_vec[victim] = 0
                    if victim == slot:
                        break
        return active, state

    def _complete_paged(self, task: _PrefillTask, sched: Scheduler, state, now, outputs,
                        histories, pending_host, pos_host, temps_host):
        """Prefill completion in paged mode: commit the donor's rows past the
        shared boundary into pages, publish the prefix on a miss, sample the
        first token (or resume a preemption's pending token), then activate
        into a free lane — or PARK resident in pages until a lane frees.
        Returns (state, first tokens emitted: 0 for a resumed
        continuation)."""
        req, rid = task.req, task.req.rid
        tail = self._store.snapshot_tail(task.donor) if self._store.tail_leaves else None
        self._store.store_donor(rid, task.donor, fill=task.fill, tail=tail)
        if task.publish:
            self._store.publish_prefix(rid, task.share_key, n_rows=task.share_rows,
                                       tail=task.boundary_tail)
            self._inflight_keys.pop(task.share_key, None)
        m = sched.unplaced_metrics(rid)
        for name, val in self._resumed.pop(rid, {}).items():
            setattr(m, name, val)
        m.prefill_s += task.prefill_s
        temp = self._slot_temperature(req)
        gen_inc = 0
        if req.resume_token is not None:
            first = int(req.resume_token)
        else:
            first = int(self._sample(task.first_logits, np.asarray([temp], np.float32))[0])
            outputs[rid] = [first]
            gen_inc = 1
            sched.first_token_unplaced(rid, now())
        info = {"pending": first, "fill": task.fill, "temp": temp,
                "history": [int(t) for t in np.asarray(req.tokens)] + [first]}
        if m.tokens_out >= m.gen_len:
            # gen_len == 1: finished without ever taking a lane
            sched.finish_unplaced(rid, now())
            self._store.free(rid)
            return state, gen_inc
        free = sched.free_slots()
        if free:
            donor = {n: task.donor[n] for n in self._store.tail_leaves} if self._fused \
                else task.donor
            state = self._occupy(sched, state, donor, free[0], rid, info, pending_host,
                                 pos_host, temps_host, histories)
        else:
            self._parked[rid] = info
            self._store.unpin(rid)      # parked: cold, host-spillable
        return state, gen_inc

    # -- async ingestion ------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Hand a request to a RUNNING ``run()`` (from any thread): it is
        drained into the scheduler at the next step boundary and gated by its
        ``arrival_s`` like any trace-driven request. A request submitted
        when no loop runs waits for the next ``run()``."""
        self._inbox.append(req)

    def _drain_inbox(self, sched: Scheduler, seen_rids: set, now: float) -> None:
        """Move every submitted request into the scheduler, popping one at a
        time (a submit that lands meanwhile is kept). A duplicate rid or
        ``gen_len < 1`` is recorded as a refusal, as ``run()``'s list would
        raise: one bad submission must not stop the loop for the others."""
        while self._inbox:
            r = self._inbox.pop(0)
            if r.rid in seen_rids:
                sched.refused.append(Refusal(r.rid, "invalid: duplicate rid in this run"))
                continue
            if r.gen_len < 1:
                sched.refused.append(Refusal(
                    r.rid, "invalid: gen_len must be >= 1 (the first token always "
                           "comes from prefill)"))
                continue
            seen_rids.add(r.rid)
            sched.submit(r, now)

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
        # paged run-state (parking, preemption stashes, publisher locks)
        self._parked, self._resumed, self._inflight_keys = {}, {}, {}
        self._act_stamp, self._act_seq, self._preempt_count = {}, 0, 0
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        for r in requests:
            sched.submit(r, now())

        state = self._init_state()
        # host mirrors of per-slot decode-loop state: the pending token
        # (emitted but not yet consumed by the model), the cache fill, the
        # sampling temperature and the committed token history (prompt +
        # emitted: a preempted request's continuation prompt and the
        # drafter's lookup corpus)
        pending_host = np.zeros(self.batch, np.int64)
        pos_host = np.zeros(self.batch, np.int64)
        temps_host = np.full(self.batch, self.sampling.temperature, np.float32)
        histories: dict[int, list[int]] = {}
        outputs: dict[str, list[int]] = {}
        tasks: list[_PrefillTask] = []
        step_log: list[dict] = []
        step = 0
        padded_steady = 0
        generated = 0
        prefill_tokens_total = 0
        decode_emitted = 0          # tokens emitted by phase-2 steps
        slot_steps = 0              # per-slot phase-2 participations
        decode_steps = 0            # plain (k = 0) decode steps
        verify_steps = 0            # speculative verify rounds
        spec_proposed_total = 0
        spec_accepted_total = 0
        spec_slot_rounds = 0        # (slot, round) pairs that speculated
        chunk = self.policy.chunk

        seen_rids = set(rids)
        while sched.has_work() or tasks or self._inbox:
            t_step0 = time.perf_counter()
            self._drain_inbox(sched, seen_rids, now())
            sched.release(now())

            # -- reservation: every free slot starts a chunk schedule --------
            # (paged mode: activation and admission are PAGE decisions —
            # drain parked requests into freed lanes, then admit lane-less)
            if self._store is not None:
                state = self._activate_parked(sched, state, pending_host, pos_host,
                                              temps_host, histories)
                self._reserve_paged(sched, tasks, now, step)
            else:
                while True:
                    free = sched.free_slots()
                    if not free:
                        break
                    req = sched.next_admissible(now())
                    if req is None:
                        break
                    bucket = req.bucket or self.policy.assign(req.prompt_len)
                    if not bucket:
                        # admission off + prompt beyond the largest bucket:
                        # still cover the whole prompt in whole chunks
                        bucket = BucketPolicy.round_up(req.prompt_len, chunk)
                    req.bucket = bucket
                    padded = np.zeros((1, bucket), np.int64)
                    padded[0, :req.prompt_len] = np.asarray(req.tokens, np.int64)
                    tasks.append(_PrefillTask(
                        req=req, slot=free[0], padded=padded,
                        n_chunks=bucket // chunk, donor=self._new_donor()))
                    sched.reserve(free[0], req, step)

            # -- unified step, phase 1: one chunk per in-flight prefill ------
            ran: list[_PrefillTask] = []
            for task in tasks:
                c0 = task.chunk_idx * chunk
                seg = task.padded[:, c0:c0 + chunk]
                n_real = max(0, min(task.req.prompt_len - c0, chunk))
                if task.fill + chunk > self.max_len:
                    raise RuntimeError(
                        f"prefill chunk for {task.req.rid!r} would overrun "
                        f"max_len={self.max_len} (admission off?)")
                last = self._chunk(task, seg, n_real)
                if self._drafter is not None:
                    # a draft-model drafter mirrors the chunk schedule into
                    # its own donor (a no-op for the n-gram drafter)
                    self._drafter.on_chunk(task.req.rid, task.padded[:, c0:c0 + chunk],
                                           n_real)
                task.chunk_idx += 1
                ran.append(task)
                if n_real:
                    task.fill += n_real
                    task.first_logits = last
                if (task.publish and task.boundary_tail is None
                        and self._store.tail_leaves and task.fill >= task.share_rows):
                    # tail families: the prefix entry must restore the state
                    # AT the boundary (chunk-aligned, so the crossing is exact)
                    task.boundary_tail = self._store.snapshot_tail(task.donor)
            chunk_tokens = len(ran) * chunk
            prefill_tokens_total += chunk_tokens

            active = sched.active_slots()
            if sched.queue and self._store is None:
                # released queue still has work: every free, unreserved slot
                # this step is waste (0 by construction with per-step
                # admission; a tripwire for future scheduling policies)
                padded_steady += self.batch - len(active) - len(tasks)

            # -- phase 2: one decode OR verify step over every occupied slot -
            emitted_this_step = 0
            # per-slot speculative depth, priced per step: clipped to the
            # slot's remaining budget, 0 where drafting does not pay (or
            # speculation is off)
            k_vec = np.zeros(self.batch, np.int64)
            if active and self._spec_policy is not None:
                for slot in active:
                    s_ = sched.slots[slot]
                    remaining = s_.request.gen_len - s_.metrics.tokens_out
                    k_vec[slot] = self._spec_policy.depth(slot, int(pos_host[slot]),
                                                          remaining)
            if active and self._store is not None:
                # page growth for the rows this step may commit; exhaustion
                # preempts LIFO back to the queue head
                active, state = self._grow_or_preempt(active, k_vec, sched, state,
                                                      pos_host, histories)
            if active:
                if int(pos_host[active].max()) >= self.max_len:
                    raise RuntimeError(
                        f"active slot position {int(pos_host[active].max())} "
                        f"overran max_len={self.max_len}")
                K = int(k_vec.max())
                # the steady-state fused path reads and writes the pools
                # THROUGH the block table — no page->lane gather; idle slots
                # run at position 0 on all-scratch table rows
                paged_kw = {}
                pos_step = pos_host
                if self._fused:
                    pos_step = np.zeros(self.batch, np.int64)
                    pos_step[active] = pos_host[active]
                    paged_kw = {"pools": self._store.device_pools(),
                                "tables": self._build_tables(sched, active)}
                if K == 0:
                    # exactly the plain decode step: the same call and the
                    # same sampler draw, so k = 0 speculation is identical
                    logits = run_model_step(self._graphs, "decode", self.model, self.params,
                                            state, pending_host[:, None], pos_step,
                                            **paged_kw)
                    decode_steps += 1
                    toks = self._sample(logits, temps_host)
                    emits = {slot: [int(toks[slot])] for slot in active}
                else:
                    # speculative round: draft -> ONE ragged batched verify ->
                    # accept the longest prefix + the corrected token
                    drafts = self._drafter.propose(active, histories, k_vec, self.batch, K)
                    span = np.concatenate([pending_host[:, None], drafts], axis=1)
                    # lane mode: the whole table takes the span write (idle
                    # lanes included), so the guard covers every slot
                    assert_span_fits(pos_step, K + 1, self._state_len)
                    logits = run_model_step(self._graphs, "verify", self.model, self.params,
                                            state, span, pos_step, **paged_kw)
                    # the target token at EVERY span row (per-slot
                    # temperature): row j validates draft j+1, row m is the
                    # corrected token of a slot accepting m drafts
                    tgt = self._sample(logits, temps_host)
                    m_vec = accept_span(drafts, tgt, k_vec)
                    commit = self.model.verify_commit_paged if self._fused \
                        else self.model.verify_commit
                    if commit is not None:
                        # recurrent families: replay each active slot's
                        # pending token and its m accepted drafts (n_commit
                        # m + 1; 0 leaves idle slots exactly as they were),
                        # fused paged on the pools through the same tables
                        n_commit = np.zeros(self.batch, np.int64)
                        n_commit[active] = m_vec[active] + 1
                        run_commit(self._graphs, self.model, self.params, state, span,
                                   pos_step, n_commit, **paged_kw)
                    verify_steps += 1
                    emits = {}
                    for slot in active:
                        m, k = int(m_vec[slot]), int(k_vec[slot])
                        emits[slot] = [int(t) for t in drafts[slot, :m]] + [int(tgt[slot, m])]
                        if k > 0:
                            sched.spec_round(slot, proposed=k, accepted=m)
                            self._spec_policy.update(slot, k, m)
                            spec_proposed_total += k
                            spec_accepted_total += m
                            spec_slot_rounds += 1
                        self._drafter.on_commit(slot, m)
                for slot, emit in emits.items():
                    sched.step_done(slot, n=len(emit))
                    pos_host[slot] += len(emit)
                    pending_host[slot] = emit[-1]
                    outputs[sched.slots[slot].request.rid].extend(emit)
                    if slot in histories:
                        histories[slot].extend(emit)
                    generated += len(emit)
                    emitted_this_step += len(emit)

            # -- phase 3: shared-step time attribution (prefill vs decode) ---
            decode_emitted += emitted_this_step
            slot_steps += len(active)
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
                tasks.remove(task)
                if self._store is not None:
                    state, gen_inc = self._complete_paged(
                        task, sched, state, now, outputs, histories, pending_host,
                        pos_host, temps_host)
                    generated += gen_inc
                    continue
                # prefill complete: graft the donor into its reserved slot,
                # sample the first token, occupy
                slot = task.slot
                temps_host[slot] = self._slot_temperature(task.req)
                first = int(self._sample(task.first_logits,
                                         temps_host[slot:slot + 1])[0])
                validate_donor(state, task.donor, self.model.state_batch_axes(state))
                state = self.model.insert_slot(state, task.donor, slot)
                sched.place(task.req, slot)
                sched.add_prefill_time(slot, task.prefill_s)
                sched.first_token(slot, now())
                generated += 1
                outputs[task.req.rid] = [first]
                pending_host[slot] = first
                pos_host[slot] = task.fill
                # the committed token history (prompt + emitted): the
                # drafter's lookup corpus, reset on every slot reuse
                histories[slot] = [int(t) for t in np.asarray(task.req.tokens)] + [first]
                if self._spec_policy is not None:
                    self._spec_policy.reset(slot)
                    self._drafter.on_graft(task.req.rid, slot, histories[slot])
                if sched.slot_done(slot):           # gen_len == 1 edge case
                    sched.finish(slot, now())
                    state = self.model.reset_slot(state, slot)
                    histories.pop(slot, None)
                    if self._drafter is not None:
                        self._drafter.on_finish(slot)
            for slot in list(active):
                if sched.slot_done(slot):
                    rid_done = sched.slots[slot].request.rid
                    sched.finish(slot, now())
                    state = self.model.reset_slot(state, slot)
                    histories.pop(slot, None)
                    if self._store is not None:
                        self._store.free(rid_done)
                        self._act_stamp.pop(slot, None)
                    if self._drafter is not None:
                        self._drafter.on_finish(slot)

            if ran or active:
                step += 1           # a unified step actually did device work
            elif not sched.active_slots() and not tasks:
                nxt = sched.next_arrival_s()
                if nxt is not None and not sched.queue and not self._inbox:
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
            "jit_cache": self._graphs.sizes(self._step_kinds()),
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
            if self.spec is not None:
                report["cost_model"]["verify_seconds_k_max"] = \
                    self.cost_model.verify_seconds(self._k_max)
        if self._store is not None:
            st = self._store
            budget_bytes = st.n_pages * st.page_bytes
            contig_slot = max(st.contiguous_bytes_per_slot(self.max_len), 1)
            report["paged"] = {
                "page_size": st.page,
                "page_bytes": st.page_bytes,
                "n_pages": st.n_pages,
                "hbm_budget_bytes": budget_bytes,
                # bytes priced from the pages actually allocated
                "hbm_bytes_resident": st.hbm_bytes_resident(),
                "hbm_bytes_resident_peak": st.pages_used_peak * st.page_bytes,
                "pages_used_peak": st.pages_used_peak,
                "resident_requests": st.resident_requests(),
                "resident_requests_peak": st.resident_peak,
                # what a contiguous max-len slot table holds at the same budget
                "contiguous_resident_bound": budget_bytes // contig_slot,
                "prefix_hits": st.prefix_store.hits,
                "prefix_misses": st.prefix_store.misses,
                "prefix_entries": len(st.prefix_store.entries),
                "cow_copies": st.cow_copies,
                "preemptions": self._preempt_count,
                "int8": st.int8,
                "fused": self._fused,
                # host spill tier: cold unshared pages evicted to host memory
                "spills": st.spills,
                "rehydrates": st.rehydrates,
                "spilled_pages": st.spilled_pages(),
                "host_spill_bytes": st.host_spill_bytes(),
                # fused accounting: lane_activations counts full page->lane
                # gathers (the fallback); fused activations restore the tails
                # only — gather_bytes_eliminated is what those skipped
                # gathers would have moved
                "lane_activations": self._lane_activations,
                "tail_restores": self._tail_restores,
                "gather_bytes_eliminated": self._gather_bytes_eliminated,
                "gather_bytes_eliminated_per_step":
                    self._gather_bytes_eliminated / max(decode_steps + verify_steps, 1),
                "decode_steps": decode_steps,
                "verify_steps": verify_steps,
            }
        if self.spec is not None:
            # accepted rate and mean accepted span, overall and by bucket
            by_b: dict[int, list[int]] = {}
            for m in finished:
                acc = by_b.setdefault(m.bucket, [0, 0, 0, 0])
                acc[0] += 1
                acc[1] += m.spec_proposed
                acc[2] += m.spec_accepted
                acc[3] += m.verify_rounds
            accept_by_bucket = {
                b: {"n": n, "proposed": p, "accepted": a,
                    "accepted_rate": a / max(p, 1),
                    # each speculating round emits its accepted drafts + 1
                    "mean_accepted_span": (a + r) / max(r, 1)}
                for b, (n, p, a, r) in sorted(by_b.items())
            }
            report["spec"] = {
                "drafter": self.spec.drafter,
                "k_max": self._k_max,
                "decode_steps": decode_steps,
                "verify_steps": verify_steps,
                "drafted_tokens": spec_proposed_total,
                "accepted_tokens": spec_accepted_total,
                "accepted_rate": spec_accepted_total / max(spec_proposed_total, 1),
                "mean_accepted_span":
                    (spec_accepted_total + spec_slot_rounds) / max(spec_slot_rounds, 1),
                # < 1.0: speculation emitted more tokens than it ran phase-2
                # steps
                "steps_per_emitted_token":
                    (decode_steps + verify_steps) / max(decode_emitted, 1),
                # per-SLOT step participations per emitted token: exactly 1.0
                # for plain decode, < 1.0 iff verify rounds accepted drafts
                "slot_steps_per_emitted_token": slot_steps / max(decode_emitted, 1),
                "accept_by_bucket": accept_by_bucket,
            }
        return report
