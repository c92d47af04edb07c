"""Slot-table scheduler for per-step continuous batching (mirrors
``repro/serve/scheduler.py`` without its mesh pricing, which comes with the
sharded engine).

Pure host-side control plane — no torch in here. The engine owns the device
state; the scheduler owns the request stream (arrival-gated queue), the
per-slot lifecycle (free -> reserved-for-prefill -> occupied -> free),
per-request SLA/deadline accounting, and the admission decision. Admission
is roofline-informed: it prices with the SAME analytic ``cost()`` terms the
generated library carries (UPD cost channel) against the roofline figures
of the library's own target SRU — the ``h100`` datasheet figures on the
card, the nominal ``torch_cpu`` figures on the host.

Arrivals are asynchronous: ``submit()`` may be called with a future
``arrival_s`` (a trace) or at any wall moment; a request becomes visible to
admission only once ``now >= arrival_s``, and every latency metric is
measured from that arrival.

Prompts are length-bucketed before admission (:class:`BucketPolicy`): each
prompt is padded to the smallest UPD-declared bucket, so the engine only
ever runs prefill shapes from a small declared set. Bucket sizes and the
prefill chunk are UPD data (``attention_prefill_chunk``'s ``serve:`` block),
not engine constants.

Refusals are permanent and carry a reason (``over_budget`` — the request's
bucket does not fit the slot table's max_len or exceeds the largest declared
bucket; ``sla_infeasible`` — even the best-case estimate misses its
deadline). Paged serving adds :class:`PagedAdmission`, whose page shortage
DEFERS (``defer:`` reasons keep the request at the head of the queue), and a
lane-less track of requests that prefill or park without a lane.

Speculative decoding adds per-request accounting (drafts proposed and
accepted, verify rounds; ``tokens_out`` counts only target-emitted tokens)
and the verify step's price, ``CostModelAdmission.verify_seconds``, which the
speculation policy weighs against expected accepted tokens.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass


def upd_serve_defaults() -> dict:
    """The ``serve:`` block declared on the attention_prefill_chunk
    primitive: {"chunk": int, "buckets": (int, ...)}. A corpus without the
    primitive or the block raises: the serving shapes are corpus data."""
    from repro_torch.core import load_corpus

    prims = load_corpus().primitives
    if "attention_prefill_chunk" not in prims:
        raise KeyError("the UPD corpus has no attention_prefill_chunk primitive "
                       "(its serve: block declares the prefill chunk and buckets)")
    blk = prims["attention_prefill_chunk"].extra.get("serve")
    if not blk or "chunk" not in blk or "buckets" not in blk:
        raise KeyError("attention_prefill_chunk carries no serve: {chunk, buckets} "
                       "block in the UPD corpus")
    return {"chunk": int(blk["chunk"]),
            "buckets": tuple(int(b) for b in blk["buckets"])}


class BucketPolicy:
    """Pad each prompt to the smallest declared bucket size.

    Buckets must be sorted, unique, positive multiples of the prefill chunk
    size — so every padded prompt decomposes into an exact number of
    fixed-shape chunk steps (``bucket // chunk``).
    """

    def __init__(self, buckets, chunk: int):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or chunk < 1:
            raise ValueError("need at least one bucket and chunk >= 1")
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be sorted and unique: {buckets}")
        bad = [b for b in buckets if b <= 0 or b % chunk]
        if bad:
            raise ValueError(
                f"buckets must be positive multiples of chunk={chunk}: {bad}")
        self.buckets = buckets
        self.chunk = int(chunk)

    @classmethod
    def from_upd(cls, chunk: int | None = None,
                 buckets=None) -> "BucketPolicy":
        """Policy from the UPD serve block. A caller-chosen ``chunk`` that
        does not divide the declared buckets rounds each bucket UP to the
        next chunk multiple (deduplicated)."""
        d = upd_serve_defaults()
        chunk = int(chunk if chunk is not None else d["chunk"])
        cand = buckets if buckets is not None else d["buckets"]
        rounded = sorted({cls.round_up(b, chunk) for b in cand})
        return cls(rounded, chunk)

    @staticmethod
    def round_up(n: int, chunk: int) -> int:
        """Smallest multiple of ``chunk`` >= n."""
        return -(-int(n) // int(chunk)) * int(chunk)

    def assign(self, prompt_len: int) -> int | None:
        """Smallest bucket >= prompt_len, or None if none fits."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return None


@dataclass
class Request:
    """One serving request: a prompt, a generation budget, an optional SLA.

    ``sla_s`` is an end-to-end latency deadline in seconds, measured from
    ``arrival_s``. ``arrival_s`` may be preset to a FUTURE engine-clock time
    (trace-driven arrivals); when left at 0.0 ``submit`` stamps it.
    ``temperature`` overrides the engine's SamplingConfig for this request
    (<= 0 -> greedy). Paged serving: ``shared_prefix_len`` is the
    prefix-store boundary hint (leading tokens shared across requests, a
    system prompt; None lets the engine share the whole prompt minus its
    last token), and ``resume_token`` is set on a PREEMPTED continuation —
    the emitted but unconsumed token to resume with instead of sampling a
    first one. ``embeds``: the request's media, which ride its first
    prefill chunk: the audio family's (enc_len, D) encoder frames or the vlm
    family's (vision_prefix, D) patch embeddings (None: zeros)."""

    rid: str
    tokens: object                  # prompt token array (1-D, int)
    gen_len: int
    sla_s: float | None = None
    arrival_s: float = 0.0
    bucket: int = 0                 # stamped at admission (BucketPolicy)
    temperature: float | None = None
    shared_prefix_len: int | None = None
    resume_token: int | None = None
    embeds: object | None = None    # per-request media: audio frames, vlm patches

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))


@dataclass
class RequestMetrics:
    """Per-request accounting the engine reports (and tests assert on)."""

    rid: str
    slot: int = -1
    prompt_len: int = 0
    gen_len: int = 0
    bucket: int = 0                 # padded prompt length (length bucketing)
    tokens_out: int = 0
    ttft_s: float = 0.0             # arrival -> first token (queue + prefill)
    prefill_s: float = 0.0          # step time attributed to prefill chunks
    decode_s: float = 0.0           # step time attributed to decode tokens
    decode_tokens_per_s: float = 0.0
    latency_s: float = 0.0          # arrival -> last token
    sla_s: float | None = None
    sla_met: bool | None = None     # None: no SLA attached
    admitted_at_step: int = -1      # engine step index at slot reservation
    # speculative decoding: tokens_out and decode_tokens_per_s count only
    # target-emitted tokens (accepted drafts + the corrected token)
    spec_proposed: int = 0          # draft tokens proposed for this request
    spec_accepted: int = 0          # draft tokens the target accepted
    verify_rounds: int = 0          # verify steps this request took part in
    preemptions: int = 0            # paged serving: times preempted on page
                                    # exhaustion and requeued as a continuation


@dataclass
class Refusal:
    rid: str
    reason: str


# attention layers a decode step reads a cache in, per family priced: the lm
# backbone's (dense, moe, vlm) one a layer; zamba applies its one shared
# block after every attn_every Mamba2 layers; a whisper decoder layer reads
# two, its self-attention cache and the cross K/V
_ATTN_LAYERS = {"dense": lambda cfg: cfg.n_layers, "moe": lambda cfg: cfg.n_layers,
                "vlm": lambda cfg: cfg.n_layers, "ssm": lambda cfg: 0,
                "hybrid": lambda cfg: cfg.n_layers // max(cfg.attn_every, 1),
                "audio": lambda cfg: 2 * cfg.n_layers}
# families whose speculative commit replays the accepted prefix
_REPLAY_COMMIT = ("ssm", "hybrid")


class CostModelAdmission:
    """Roofline admission driven by the generated library's cost channel.

    A decode step over the full slot table is modeled as memory-bound:
      bytes/step = param bytes (weights stream once per token)
                 + n_attn_layers x lib.cost("attention_decode", "bytes", ...)
      step_s     = bytes / TARGET.hbm_bw
    with n_attn_layers n_layers for the dense family, 0 for rwkv (ssm),
    whose step is its param bytes alone, n_layers // attn_every for
    zamba (hybrid: 13 shared-block applications for zamba2-7b), and two a
    decoder layer for whisper (audio: the self-attention cache at the fill,
    the cross K/V at the fixed ``enc_len``, default the fill, as
    ``repro/serve/scheduler.py:327-331`` prices them), and n_layers for the
    moe and vlm families. The
    reference adds each family's recurrent-state term (``ssd_scan`` /
    ``wkv6_scan``) only to the collective bytes of a tensor-parallel mesh
    (``comms_bytes_per_step``), which vanish at one shard, so neither
    appears here. Prefill is modeled as
    compute-bound and priced at the request's BUCKET: parameter flops plus
    the ``attention_prefill_chunk`` cost term summed over the chunk
    schedule, over TARGET.peak_flops_bf16.

    A verify step at draft depth k is priced like a decode step with the
    ``attention_verify`` bytes term at span k+1 (``verify_seconds``); rwkv
    and zamba pay twice that for the commit replay of the accepted prefix.
    With ``spec_k`` set, admission charges the cheaper of a decode step and
    a fully accepted span per emitted token.

    ``param_bytes`` is the reference's ``cfg.param_count()``, which for
    rwkv omits a few leaves of the real tree (7.00 B against 7.53 B for
    rwkv6-7b): admission prices as the reference does; for the moe family
    it counts the ACTIVE parameters (``active_only``: the routed
    experts_per_token experts of each layer), as the reference does.

    The vlm family's vision prefix (``cfg.decode_prefix`` rows ahead of the
    prompt) takes slot-table rows like prompt tokens: it is added to the
    rows a request needs, to the cache fill its attention reads are charged
    at, and to every prefill chunk's fill (``repro/serve/scheduler.py:
    464``, ``:508-511``).

    All are deliberately idealized (roofline = best case), so a request
    whose deadline fails even the best case is hopeless and refusing it is
    sound. ``lib`` is the generated library the engine runs on; a missing
    cost term raises (the corpus defines every term this prices).
    """

    def __init__(self, cfg, batch: int, max_len: int, *, lib,
                 policy: BucketPolicy | None = None, enc_len: int | None = None):
        if cfg.family not in _ATTN_LAYERS:
            raise NotImplementedError(f"admission prices the families "
                                      f"{sorted(_ATTN_LAYERS)} only, not {cfg.family!r}")
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.enc_len = enc_len          # audio: the fixed cross K/V length
        self.lib = lib
        self.policy = policy            # None -> exact-length admission
        self.prefix = cfg.decode_prefix  # vlm: the vision rows ahead of the prompt
        self.param_bytes = self._params() * self._dtype_bytes()
        self._attn_layers = _ATTN_LAYERS[cfg.family](cfg)
        self.hbm_bw = float(lib.TARGET.hbm_bw)
        self.peak_flops = float(lib.TARGET.peak_flops_bf16)
        self._step_s = None             # computed lazily, cached (pure shapes)
        # speculative decoding: the engine sets spec_k > 0 when it runs a
        # drafter, and admission then prices decode at the best case of plain
        # decode and a fully accepted verify span
        self.spec_k = 0

    def _dtype_bytes(self) -> int:
        return 2 if "16" in self.cfg.dtype else 4

    def _params(self) -> int:
        """The parameters a token streams: the moe family's active ones."""
        return self.cfg.param_count(active_only=(self.cfg.family == "moe"))

    def _attn_bytes(self, prim: str, s: int, **shape) -> float:
        """Every attention layer's bytes of one step over the slot table
        (UPD cost channel, ``prim`` at cache fill ``s``): a whisper decoder
        layer reads its cache at ``s`` and its cross K/V at ``enc_len``.
        The UPD bytes formulas follow the bf16 convention (2 B/elem):
        rescaled to the serving dtype, as the params are priced."""
        cfg = self.cfg

        def per_layer(s_: int) -> float:
            return self.lib.cost(prim, "bytes", B=self.batch, H=cfg.n_heads,
                                 KH=cfg.n_kv_heads, S=s_, D=cfg.hd, **shape)

        if cfg.family == "audio":
            enc = self.enc_len if self.enc_len is not None else s
            raw = cfg.n_layers * (per_layer(s) + per_layer(enc))
        else:
            raw = self._attn_layers * per_layer(s)
        return raw * (self._dtype_bytes() / 2.0)

    def decode_bytes_per_step(self, s: int | None = None) -> float:
        """Bytes one full-slot-table decode step moves (UPD cost channel).
        ``s`` is the cache fill to charge attention reads at; defaults to
        the slot table's max_len (steady-state worst case)."""
        return self.param_bytes + self._attn_bytes(
            "attention_decode", self.max_len if s is None else s)

    def step_seconds(self, s: int | None = None) -> float:
        if s is not None:
            return self.decode_bytes_per_step(s) / self.hbm_bw
        if self._step_s is None:
            self._step_s = self.decode_bytes_per_step() / self.hbm_bw
        return self._step_s

    def verify_seconds(self, k: int, s: int | None = None) -> float:
        """Best-case time of one verify step over the full slot table at
        draft depth k (span SV = k+1): memory-bound like decode — the params
        stream once whatever the span — plus n_attn_layers x the
        ``attention_verify`` bytes term at cache fill ``s`` (default
        max_len). rwkv and zamba pay the commit replay of the accepted
        prefix through the chunked-prefill path, modeled as a factor of 2.
        The price the speculation policy weighs against expected accepted
        tokens."""
        attn = self._attn_bytes("attention_verify", self.max_len if s is None else s,
                                SV=int(k) + 1)
        commit_factor = 2.0 if self.cfg.family in _REPLAY_COMMIT else 1.0
        return (self.param_bytes + attn) / self.hbm_bw * commit_factor

    def emit_seconds_per_token(self, s: int | None = None) -> float:
        """Best-case seconds per EMITTED token: a plain decode step or, with
        speculation on, a fully accepted verify span at spec_k (k+1 tokens a
        step), whichever is cheaper."""
        per_tok = self.step_seconds(s)
        if self.spec_k > 0:
            per_tok = min(per_tok, self.verify_seconds(self.spec_k, s) / (self.spec_k + 1))
        return per_tok

    def prefill_seconds(self, padded_len: int) -> float:
        """Best-case prefill time for ``padded_len`` prompt tokens: parameter
        flops + the attention_prefill_chunk cost term summed over the chunk
        schedule (each chunk priced at its own growing cache fill)."""
        cfg = self.cfg
        flops = 2.0 * self._params() * padded_len
        chunk = self.policy.chunk if self.policy else padded_len
        fills = range(chunk, padded_len + 1, chunk) if self._attn_layers else ()
        for fill in fills:
            flops += self._attn_layers * self.lib.cost(
                "attention_prefill_chunk", "flops", B=1, H=cfg.n_heads,
                KH=cfg.n_kv_heads, C=chunk, S=self.prefix + fill, D=cfg.hd)
        return flops / self.peak_flops

    def admit(self, req: Request, now_s: float) -> tuple[bool, str]:
        if self.policy is not None:
            bucket = self.policy.assign(req.prompt_len)
            if bucket is None:
                return False, (f"over_budget: prompt {req.prompt_len} exceeds "
                               f"largest bucket {self.policy.buckets[-1]}")
        else:
            bucket = req.prompt_len
        if self.prefix + bucket + req.gen_len > self.max_len:
            return False, (f"over_budget: bucket {bucket} (prompt "
                           f"{req.prompt_len}) + gen {req.gen_len}"
                           + (f" + vision prefix {self.prefix}" if self.prefix else "")
                           + f" > max_len {self.max_len}")
        if req.sla_s is not None:
            waited = max(0.0, now_s - req.arrival_s)
            # charge attention reads at THIS request's maximal cache fill
            s_req = self.prefix + bucket + req.gen_len
            projected = (waited + self.prefill_seconds(bucket)
                         + req.gen_len * self.emit_seconds_per_token(s_req))
            if projected > req.sla_s:
                return False, (f"sla_infeasible: projected {projected:.3e}s "
                               f"> sla {req.sla_s:.3e}s")
        req.bucket = bucket
        return True, "ok"


class PagedAdmission(CostModelAdmission):
    """Page-count admission for the paged slot store: admit on pages
    allocatable NOW, not on worst-case bucket bytes.

    The price is the pages the request's PROMPT needs at attach (decode
    growth is paid step by step, with preemption as the backstop), against
    ``budget.pages_free()`` — the free list, evictable prefix-store pages
    and host-spillable pages. ``budget`` is anything with
    ``pages_for_rows(rows)`` and ``pages_free()`` (the
    :class:`repro_torch.serve.paging.PagedKVStore` interface). Pages are
    priced in the store's own ``page_bytes`` (int8 pages: the payload plus
    a float32 scale a row), so one byte budget admits as many pages as the
    reference's.

    A page shortage is TRANSIENT, so it defers rather than refuses: the
    ``defer:`` reason makes ``Scheduler.next_admissible`` keep the request
    at the FRONT of the queue. A preempted continuation (``resume_token``
    set) skips the SLA and gen-budget checks — its original admission priced
    the whole request — but still pays the page check for its longer
    re-prefill prompt."""

    def __init__(self, cfg, batch: int, max_len: int, *, lib, budget,
                 policy: BucketPolicy | None = None, enc_len: int | None = None):
        super().__init__(cfg, batch, max_len, lib=lib, policy=policy, enc_len=enc_len)
        self.budget = budget

    def admit(self, req: Request, now_s: float) -> tuple[bool, str]:
        if req.resume_token is not None:
            chunk = self.policy.chunk if self.policy else 1
            bucket = (self.policy.assign(req.prompt_len) if self.policy else None) \
                or BucketPolicy.round_up(req.prompt_len, chunk)
            if self.prefix + bucket + 1 > self.max_len:
                return False, (f"over_budget: continuation prompt {req.prompt_len} "
                               f"cannot re-prefill within max_len {self.max_len}")
            req.bucket = bucket
        else:
            ok, reason = super().admit(req, now_s)
            if not ok:
                return ok, reason
        need = self.budget.pages_for_rows(self.prefix + req.prompt_len)
        free = self.budget.pages_free()
        if need > free:
            return False, (f"defer: needs {need} pages for its prompt, "
                           f"{free} allocatable now")
        return True, "ok"


@dataclass
class _Slot:
    request: Request | None = None     # occupied: decoding
    reserved: Request | None = None    # reserved: prefill chunks in flight
    metrics: RequestMetrics | None = None
    served: int = 0                    # lifetime requests this slot carried

    @property
    def free(self) -> bool:
        return self.request is None and self.reserved is None


class Scheduler:
    """Arrival-gated request stream + slot table + SLA accounting.

    Protocol (driven by the engine once per unified step):
      submit(req, now)                 — enqueue (future arrival_s -> pending)
      release(now)                     — move arrived requests into the queue
      next_admissible(now)             — pop the next request that passes
                                         admission; refused requests are
                                         recorded and dropped
      reserve(slot, req, step)         — slot enters prefill (chunks running)
      place(req, slot)                 — prefill done: slot occupied
      first_token(slot, now)           — TTFT stamp
      step_done(slot, n)               — n real tokens emitted in this slot
      spec_round(slot, proposed, accepted) — one verify round's drafts
      attribute_step_time(...)         — split a shared step's wall time
                                         between prefill and decode tokens
      finish(slot, now) -> metrics     — request complete, slot freed

    Paged mode adds a lane-less track: reserve_unplaced / place_parked /
    first_token_unplaced / finish_unplaced (admission and parking are
    page-count decisions, not lane decisions) and preempt / requeue_front
    (page exhaustion sends a decoding request back to the queue head as a
    resumable continuation).
    """

    def __init__(self, n_slots: int, admission: CostModelAdmission | None = None):
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.pending: list[tuple[float, int, Request]] = []   # arrival heap
        self._seq = 0
        self.admission = admission
        self.finished: list[RequestMetrics] = []
        self.refused: list[Refusal] = []
        self.admission_log: list[dict] = []   # {step, slot, rid} per admission
        # paged serving: requests admitted WITHOUT a lane (prefilling into a
        # donor, or parked resident in pages awaiting a free lane)
        self.unplaced: dict[str, tuple[Request, RequestMetrics]] = {}

    # -- request stream -------------------------------------------------------

    def submit(self, req: Request, now_s: float) -> None:
        """A request with a future ``arrival_s`` is held pending until the
        engine clock reaches it; a preset PAST arrival is honored (the wait
        counts toward TTFT/SLA); an unset arrival (0.0) is stamped now."""
        if req.arrival_s > now_s:
            heapq.heappush(self.pending, (req.arrival_s, self._seq, req))
            self._seq += 1
        else:
            if req.arrival_s <= 0.0:
                req.arrival_s = now_s
            self.queue.append(req)

    def release(self, now_s: float) -> int:
        """Move every pending request whose arrival time has come into the
        admission queue (arrival order). Returns how many arrived."""
        n = 0
        while self.pending and self.pending[0][0] <= now_s:
            _, _, req = heapq.heappop(self.pending)
            self.queue.append(req)
            n += 1
        return n

    def next_arrival_s(self) -> float | None:
        return self.pending[0][0] if self.pending else None

    def next_admissible(self, now_s: float) -> Request | None:
        while self.queue:
            req = self.queue.popleft()
            if self.admission is None:
                return req
            ok, reason = self.admission.admit(req, now_s)
            if ok:
                return req
            if reason.startswith("defer"):
                # transient shortage (paged admission: pages free up as
                # decodes finish): keep FIFO order, try again next step
                self.queue.appendleft(req)
                return None
            self.refused.append(Refusal(req.rid, reason))
        return None

    def requeue_front(self, req: Request) -> None:
        """Put a request at the HEAD of the queue: a preempted continuation
        (it was already being served) or an attach that lost a page race."""
        self.queue.appendleft(req)

    # -- slot lifecycle -------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    def reserved_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.reserved is not None]

    def reserve(self, slot: int, req: Request, step: int) -> None:
        s = self.slots[slot]
        if not s.free:
            raise ValueError(f"slot {slot} is not free")
        s.reserved = req
        self.admission_log.append({"step": step, "slot": slot, "rid": req.rid})
        s.metrics = RequestMetrics(
            rid=req.rid, slot=slot, prompt_len=req.prompt_len,
            gen_len=req.gen_len, bucket=req.bucket or req.prompt_len,
            sla_s=req.sla_s, admitted_at_step=step)

    def place(self, req: Request, slot: int) -> None:
        s = self.slots[slot]
        if s.reserved is not req:
            raise ValueError(f"slot {slot} is not reserved for {req.rid!r}")
        s.request = req
        s.reserved = None
        s.served += 1

    # -- paged serving: lane-less admission, parking, preemption --------------

    def reserve_unplaced(self, req: Request, step: int) -> RequestMetrics:
        """Admit a request WITHOUT reserving a lane (its prefill runs in a
        donor, and a completed request may stay parked in pages). Logged
        with slot -1; ``place_parked`` moves it into a lane later."""
        if req.rid in self.unplaced:
            raise ValueError(f"request {req.rid!r} already unplaced")
        self.admission_log.append({"step": step, "slot": -1, "rid": req.rid})
        m = RequestMetrics(
            rid=req.rid, slot=-1, prompt_len=req.prompt_len,
            gen_len=req.gen_len, bucket=req.bucket or req.prompt_len,
            sla_s=req.sla_s, admitted_at_step=step)
        self.unplaced[req.rid] = (req, m)
        return m

    def unplaced_metrics(self, rid: str) -> RequestMetrics:
        return self.unplaced[rid][1]

    def place_parked(self, rid: str, slot: int) -> Request:
        """Activate an unplaced (parked) request into a free lane, carrying
        its metrics (TTFT was stamped at prefill completion)."""
        s = self.slots[slot]
        if not s.free:
            raise ValueError(f"slot {slot} is not free")
        req, m = self.unplaced.pop(rid)
        m.slot = slot
        s.request, s.metrics = req, m
        s.served += 1
        return req

    def first_token_unplaced(self, rid: str, now_s: float) -> None:
        """TTFT stamp for a request finishing prefill without a lane."""
        req, m = self.unplaced[rid]
        m.ttft_s = max(now_s - req.arrival_s, 1e-9)
        m.tokens_out = 1

    def finish_unplaced(self, rid: str, now_s: float) -> RequestMetrics:
        """Complete a request that never got (or no longer needs) a lane —
        the parked gen_len == 1 edge case."""
        req, m = self.unplaced.pop(rid)
        return self._close(m, req, now_s)

    def preempt(self, slot: int) -> tuple[Request, RequestMetrics]:
        """Evict a DECODING request from its lane on page exhaustion. It is
        not finished: the engine stashes the metrics and requeues a
        continuation at the queue head."""
        s = self.slots[slot]
        if s.request is None:
            raise ValueError(f"slot {slot} is not decoding")
        req, m = s.request, s.metrics
        s.request, s.reserved, s.metrics = None, None, None
        return req, m

    def first_token(self, slot: int, now_s: float) -> None:
        m = self.slots[slot].metrics
        m.ttft_s = max(now_s - self.slots[slot].request.arrival_s, 1e-9)
        m.tokens_out = 1

    def step_done(self, slot: int, n: int = 1) -> None:
        """``n`` target-emitted tokens landed in this slot this step (n > 1:
        a verify round accepted n-1 drafts and the corrected token; rejected
        drafts are never counted)."""
        self.slots[slot].metrics.tokens_out += n

    def spec_round(self, slot: int, proposed: int, accepted: int) -> None:
        """Account one verify round for this slot's request."""
        m = self.slots[slot].metrics
        m.spec_proposed += proposed
        m.spec_accepted += accepted
        m.verify_rounds += 1

    def slot_done(self, slot: int) -> bool:
        s = self.slots[slot]
        return (s.request is not None
                and s.metrics.tokens_out >= s.request.gen_len)

    def attribute_step_time(self, t_step: float, prefill_tokens: int,
                            decode_slots: list[int],
                            decode_tokens: int | None = None
                            ) -> tuple[float, float]:
        """Split one shared step's wall time proportionally between the
        prefill tokens (chunk work) and decode tokens it processed. The
        decode share is credited to EVERY decoding request's ``decode_s``
        (wall time is shared, not divided); the prefill share is returned
        for the engine to credit the prefilling request(s)."""
        if decode_tokens is None:
            decode_tokens = len(decode_slots)
        total = prefill_tokens + decode_tokens
        if total == 0 or t_step <= 0:
            return 0.0, 0.0
        pre_share = t_step * prefill_tokens / total
        dec_share = t_step - pre_share
        for slot in decode_slots:
            self.slots[slot].metrics.decode_s += dec_share
        return pre_share, dec_share

    def add_prefill_time(self, slot: int, seconds: float) -> None:
        if self.slots[slot].metrics is not None:
            self.slots[slot].metrics.prefill_s += seconds

    def finish(self, slot: int, now_s: float) -> RequestMetrics:
        s = self.slots[slot]
        m, req = s.metrics, s.request
        s.request, s.reserved, s.metrics = None, None, None
        return self._close(m, req, now_s)

    def _close(self, m: RequestMetrics, req: Request, now_s: float) -> RequestMetrics:
        m.latency_s = max(now_s - req.arrival_s, 1e-9)
        decode_s = m.decode_s if m.decode_s > 0 \
            else max(m.latency_s - m.ttft_s, 1e-9)
        m.decode_tokens_per_s = max(m.tokens_out - 1, 0) / max(decode_s, 1e-9)
        if m.sla_s is not None:
            m.sla_met = m.latency_s <= m.sla_s
        self.finished.append(m)
        return m

    # -- aggregate view -------------------------------------------------------

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.pending)
                or bool(self.active_slots()) or bool(self.reserved_slots())
                or bool(self.unplaced))

    def sla_hit_rate(self) -> float | None:
        scored = [m for m in self.finished if m.sla_met is not None]
        if not scored:
            return None
        return sum(m.sla_met for m in scored) / len(scored)

    def slot_reuse(self) -> list[int]:
        return [s.served for s in self.slots]
