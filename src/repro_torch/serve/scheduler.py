"""Slot-table scheduler for per-step continuous batching (mirrors the
lane-mode half of ``repro/serve/scheduler.py``).

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
deadline).
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
    (<= 0 -> greedy)."""

    rid: str
    tokens: object                  # prompt token array (1-D, int)
    gen_len: int
    sla_s: float | None = None
    arrival_s: float = 0.0
    bucket: int = 0                 # stamped at admission (BucketPolicy)
    temperature: float | None = None

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


@dataclass
class Refusal:
    rid: str
    reason: str


class CostModelAdmission:
    """Roofline admission driven by the generated library's cost channel.

    A decode step over the full slot table is modeled as memory-bound:
      bytes/step = param bytes (weights stream once per token)
                 + n_layers x lib.cost("attention_decode", "bytes", ...)
      step_s     = bytes / TARGET.hbm_bw
    Prefill is modeled as compute-bound and priced at the request's BUCKET:
    parameter flops plus the ``attention_prefill_chunk`` cost term summed
    over the chunk schedule, over TARGET.peak_flops_bf16.

    Both are deliberately idealized (roofline = best case), so a request
    whose deadline fails even the best case is hopeless and refusing it is
    sound. ``lib`` is the generated library the engine runs on; a missing
    cost term raises (the corpus defines every term this prices).
    """

    def __init__(self, cfg, batch: int, max_len: int, *, lib,
                 policy: BucketPolicy | None = None):
        if cfg.family != "dense":
            raise NotImplementedError(f"admission prices the dense family only, "
                                      f"not {cfg.family!r}")
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.lib = lib
        self.policy = policy            # None -> exact-length admission
        self.param_bytes = cfg.param_count() * self._dtype_bytes()
        self.hbm_bw = float(lib.TARGET.hbm_bw)
        self.peak_flops = float(lib.TARGET.peak_flops_bf16)
        self._step_s = None             # computed lazily, cached (pure shapes)

    def _dtype_bytes(self) -> int:
        return 2 if "16" in self.cfg.dtype else 4

    def decode_bytes_per_step(self, s: int | None = None) -> float:
        """Bytes one full-slot-table decode step moves (UPD cost channel).
        ``s`` is the cache fill to charge attention reads at; defaults to
        the slot table's max_len (steady-state worst case)."""
        cfg = self.cfg
        raw = self.lib.cost("attention_decode", "bytes", B=self.batch,
                            H=cfg.n_heads, KH=cfg.n_kv_heads,
                            S=self.max_len if s is None else s, D=cfg.hd)
        # UPD bytes formulas follow the bf16 convention (2 B/elem): rescale
        # to the serving dtype so both terms use the same element size
        return self.param_bytes + cfg.n_layers * raw * (self._dtype_bytes() / 2.0)

    def step_seconds(self, s: int | None = None) -> float:
        if s is not None:
            return self.decode_bytes_per_step(s) / self.hbm_bw
        if self._step_s is None:
            self._step_s = self.decode_bytes_per_step() / self.hbm_bw
        return self._step_s

    def prefill_seconds(self, padded_len: int) -> float:
        """Best-case prefill time for ``padded_len`` prompt tokens: parameter
        flops + the attention_prefill_chunk cost term summed over the chunk
        schedule (each chunk priced at its own growing cache fill)."""
        cfg = self.cfg
        flops = 2.0 * cfg.param_count() * padded_len
        chunk = self.policy.chunk if self.policy else padded_len
        for fill in range(chunk, padded_len + 1, chunk):
            flops += cfg.n_layers * self.lib.cost(
                "attention_prefill_chunk", "flops", B=1, H=cfg.n_heads,
                KH=cfg.n_kv_heads, C=chunk, S=fill, D=cfg.hd)
        return flops / self.peak_flops

    def admit(self, req: Request, now_s: float) -> tuple[bool, str]:
        if self.policy is not None:
            bucket = self.policy.assign(req.prompt_len)
            if bucket is None:
                return False, (f"over_budget: prompt {req.prompt_len} exceeds "
                               f"largest bucket {self.policy.buckets[-1]}")
        else:
            bucket = req.prompt_len
        if bucket + req.gen_len > self.max_len:
            return False, (f"over_budget: bucket {bucket} (prompt "
                           f"{req.prompt_len}) + gen {req.gen_len}"
                           f" > max_len {self.max_len}")
        if req.sla_s is not None:
            waited = max(0.0, now_s - req.arrival_s)
            # charge attention reads at THIS request's maximal cache fill
            s_req = bucket + req.gen_len
            projected = (waited + self.prefill_seconds(bucket)
                         + req.gen_len * self.step_seconds(s_req))
            if projected > req.sla_s:
                return False, (f"sla_infeasible: projected {projected:.3e}s "
                               f"> sla {req.sla_s:.3e}s")
        req.bucket = bucket
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
      step_done(slot)                  — one real token decoded in this slot
      attribute_step_time(...)         — split a shared step's wall time
                                         between prefill and decode tokens
      finish(slot, now) -> metrics     — request complete, slot freed
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
            self.refused.append(Refusal(req.rid, reason))
        return None

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

    def first_token(self, slot: int, now_s: float) -> None:
        m = self.slots[slot].metrics
        m.ttft_s = max(now_s - self.slots[slot].request.arrival_s, 1e-9)
        m.tokens_out = 1

    def step_done(self, slot: int, n: int = 1) -> None:
        """``n`` emitted tokens landed in this slot this step."""
        self.slots[slot].metrics.tokens_out += n

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
        m.latency_s = max(now_s - req.arrival_s, 1e-9)
        decode_s = m.decode_s if m.decode_s > 0 \
            else max(m.latency_s - m.ttft_s, 1e-9)
        m.decode_tokens_per_s = max(m.tokens_out - 1, 0) / max(decode_s, 1e-9)
        if m.sla_s is not None:
            m.sla_met = m.latency_s <= m.sla_s
        s.request, s.reserved, s.metrics = None, None, None
        self.finished.append(m)
        return m

    # -- aggregate view -------------------------------------------------------

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.pending)
                or bool(self.active_slots()) or bool(self.reserved_slots()))

    def sla_hit_rate(self) -> float | None:
        scored = [m for m in self.finished if m.sla_met is not None]
        if not scored:
            return None
        return sum(m.sla_met for m in scored) / len(scored)

    def slot_reuse(self) -> list[int]:
        return [s.served for s in self.slots]
