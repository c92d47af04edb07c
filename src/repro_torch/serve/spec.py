"""Speculative decoding on the slot table: drafters, the acceptance rule and
cost-priced depth (mirrors ``repro/serve/spec.py``).

The engine's speculative round is draft -> verify -> accept -> commit:

* a cheap **drafter** proposes up to k tokens per slot (n-gram prompt lookup
  over the slot's committed token history; a small-config draft model from
  ``configs/registry.py`` as the second tier);
* ONE batched ragged **verify** step (``Model.verify_step``, or
  ``verify_step_paged`` straight off the page pools) scores every slot's span
  ``[pending, d_1 .. d_k]`` at its own (B,) position — logits row j
  validates draft j+1 and is independent of rows > j;
* the **acceptance rule** (:func:`accept_span`) keeps each slot's longest
  accepted prefix plus ONE corrected token from the first rejected row —
  greedy, the emitted stream equals plain decode's token for token; sampled,
  acceptance is exact match against the sampled target token;
* **commit**: the dense family already wrote the span's cache rows in the
  verify step, and rollback is kv_len truncation (free); rwkv's verify step
  writes nothing, and the commit replays each slot's accepted prefix
  (``Model.verify_commit``, per-slot real rows; 0 leaves a slot as it was).

Depth k is a per-slot, per-step decision priced by the UPD cost channel
(:class:`SpeculationPolicy`): expected emitted tokens from a per-slot
acceptance EMA against drafter cost plus the ``attention_verify`` bytes term
at span k+1 over the target SRU's ``hbm_bw``. k = 0 is today's decode step
exactly. The span bound ``k_max`` is UPD data (the ``serve:`` block on
``attention_verify`` in ``tsl_data/primitives/seq.yaml``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .graphs import StepGraphs, run_model_step, run_prefill_chunk


def upd_verify_defaults() -> dict:
    """The ``serve:`` block declared on the attention_verify primitive:
    {"k_max": int}, the largest drafted span the engine may propose per slot
    per step (verify width SV = k+1). Raises where the corpus lacks the
    primitive or its ``k_max``."""
    from repro_torch.core import load_corpus

    prim = load_corpus().primitives.get("attention_verify")
    blk = (prim.extra.get("serve") or {}) if prim is not None else {}
    if "k_max" not in blk:
        raise ValueError("the corpus declares no serve: {k_max: ...} block on "
                         "attention_verify")
    return {"k_max": int(blk["k_max"])}


def accept_span(drafts, target, window) -> np.ndarray:
    """Longest-accepted-prefix acceptance rule (pure host function).

    ``drafts`` (B, K): the proposed continuation per slot. ``target``
    (B, K+1): the target model's token at every span row — row j is what
    the target emits AFTER ``[pending, d_1..d_j]``, so ``target[:, j]``
    validates ``drafts[:, j]``. ``window`` (B,): per-slot admissible draft
    count (<= K; rows beyond it are never accepted).

    Returns ``m`` (B,): the number of leading drafts accepted per slot. The
    slot emits ``drafts[:m]`` and the corrected token ``target[:, m]``, m+1
    tokens; every accepted index j < m has drafts[j] == target[j] and
    j < window."""
    drafts = np.asarray(drafts)
    target = np.asarray(target)
    b, k = drafts.shape
    if target.shape != (b, k + 1):
        raise ValueError(f"target must be (B, K+1)={(b, k + 1)}, got {target.shape}")
    window = np.minimum(np.asarray(window, np.int64), k)
    match = drafts == target[:, :k]
    m = np.cumprod(match, axis=1).sum(axis=1) if k else np.zeros(b, np.int64)
    return np.minimum(m, np.maximum(window, 0)).astype(np.int64)


@dataclass(frozen=True)
class SpeculationConfig:
    """Engine-facing speculation knobs.

    ``k_max`` None -> the UPD serve block on attention_verify. ``drafter``
    "ngram" (host prompt lookup, no device cost) or "draft_model" (a
    small-config dense arch named by ``draft_arch``, run on its own slot
    table with the target's chunk schedule). ``fixed_k`` pins the depth;
    None -> cost-priced per slot."""

    k_max: int | None = None
    drafter: str = "ngram"
    draft_arch: str | None = None
    max_ngram: int = 3
    ema_decay: float = 0.75         # per-slot acceptance EMA smoothing
    ema_init: float = 0.5           # optimism prior for fresh slots
    fixed_k: int | None = None


class SpeculationPolicy:
    """Per-slot speculation depth priced by the UPD cost channel.

    For each candidate depth k the policy compares expected emitted tokens
    per second, E(k, a) / T(k), with a the slot's acceptance EMA,
    E(k, a) = (1 - a^(k+1)) / (1 - a) (the expected accepted prefix and the
    corrected token under i.i.d. per-draft acceptance a) and
    T(k) = k * drafter_cost + ``cost_model.verify_seconds(k, s)``. k = 0,
    priced at the plain decode step, is always a candidate, so speculation
    falls back to today's decode where drafting does not pay."""

    def __init__(self, batch: int, k_max: int, cost_model, spec_cfg,
                 drafter_cost_s: float = 0.0):
        self.k_max = int(k_max)
        self.cm = cost_model            # CostModelAdmission (host arithmetic)
        self.cfg = spec_cfg
        self.drafter_cost_s = float(drafter_cost_s)
        self.alpha = np.full(batch, float(spec_cfg.ema_init))

    def reset(self, slot: int) -> None:
        self.alpha[slot] = float(self.cfg.ema_init)

    def update(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verify round's per-draft acceptance into the slot EMA."""
        if proposed <= 0:
            return
        d = float(self.cfg.ema_decay)
        self.alpha[slot] = d * self.alpha[slot] + (1.0 - d) * (accepted / proposed)

    def expected_emitted(self, k: int, alpha: float) -> float:
        a = min(max(float(alpha), 0.0), 0.999)
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def depth(self, slot: int, fill: int, remaining: int) -> int:
        """Draft count for this slot this step; 0 -> plain decode. Clipped
        to ``remaining - 1`` so a round never emits past gen_len."""
        cap = min(self.k_max, max(int(remaining) - 1, 0))
        if cap <= 0:
            return 0
        if self.cfg.fixed_k is not None:
            return min(int(self.cfg.fixed_k), cap)
        s = int(fill) + 1
        best_k, best = 0, 1.0 / max(self.cm.step_seconds(s), 1e-30)
        a = self.alpha[slot]
        for k in range(1, cap + 1):
            t = k * self.drafter_cost_s + self.cm.verify_seconds(k, s)
            rate = self.expected_emitted(k, a) / max(t, 1e-30)
            if rate > best:
                best_k, best = k, rate
        return best_k


class NGramDrafter:
    """Tier-1 drafter: prompt lookup / n-gram continuation, on the host.

    For each slot, match the longest suffix n-gram (n from max_ngram down to
    1) of the committed token history against its rightmost earlier
    occurrence in the same history (prompt included) and propose the k
    tokens that followed it; repeating the last token fills any shortfall.
    No device cost: ``cost_per_token_s`` is 0, so the policy prices the
    verify step alone against expected acceptance."""

    def __init__(self, max_ngram: int = 3):
        self.max_ngram = int(max_ngram)

    def cost_per_token_s(self) -> float:
        return 0.0

    # engine lifecycle hooks (a stateless drafter: all no-ops)
    def on_chunk(self, rid, seg, n_real) -> None:
        pass

    def on_graft(self, rid, slot, history) -> None:
        pass

    def on_commit(self, slot, m) -> None:
        pass

    def on_finish(self, slot) -> None:
        pass

    def _continue(self, hist: np.ndarray, k: int) -> list[int]:
        n_hist = len(hist)
        for n in range(min(self.max_ngram, n_hist - 1), 0, -1):
            suffix = hist[-n:]
            # rightmost earlier occurrence of the suffix n-gram
            for start in range(n_hist - n - 1, -1, -1):
                if np.array_equal(hist[start:start + n], suffix):
                    cont = hist[start + n:start + n + k]
                    if len(cont):
                        out = [int(t) for t in cont]
                        while len(out) < k:
                            out.append(out[-1])
                        return out
        return [int(hist[-1])] * k

    def propose(self, active, histories, k_vec, batch: int, K: int) -> np.ndarray:
        """-> (batch, K) int drafts; rows of inactive slots are zeros."""
        drafts = np.zeros((batch, K), np.int64)
        for slot in active:
            if k_vec[slot] <= 0:
                continue
            drafts[slot, :] = self._continue(np.asarray(histories[slot], np.int64), K)
        return drafts


class DraftModelDrafter:
    """Tier-2 drafter: a small-config dense draft model on its own slot
    table, kept in step with the target's slot lifecycle.

    The draft state mirrors the target's chunk schedule (``on_chunk``
    advances a batch-1 draft donor with the same padded segments;
    ``on_graft`` grafts it into the draft slot table). Each ``propose``
    round then (1) catches the draft cache up to the committed history, one
    token a step (slots already caught up re-feed their newest fed token at
    its own row, an idempotent rewrite), and (2) runs K greedy draft decode
    steps. Rows written for drafts later rejected need no rollback: the next
    catch-up overwrites them (kv_len-masked until then). Its decode step and
    mirrored chunks are compiled entries of its own (``graphs``, at its batch
    and ``state_len``), the chunks staged through one donor as the engine's.

    The draft model shares the target's vocabulary: the acceptance rule
    compares token ids verbatim. ``params`` None draws the draft model's
    weights from ``init(seed)``; given, they are used as they are."""

    def __init__(self, draft_cfg, target_cfg, *, batch: int, state_len: int,
                 seed: int = 0, device: torch.device | str = "cuda",
                 target: str | None = None, params: dict | None = None):
        from repro_torch.nn.model import build_model

        if draft_cfg.family != "dense":
            raise ValueError(f"draft model {draft_cfg.name!r} must be a dense lm "
                             f"family arch, got {draft_cfg.family!r}")
        if draft_cfg.vocab != target_cfg.vocab:
            raise ValueError(f"draft vocab {draft_cfg.vocab} != target vocab "
                             f"{target_cfg.vocab}: acceptance compares token ids "
                             f"verbatim")
        self.cfg = draft_cfg
        self.batch = batch
        self.state_len = int(state_len)
        self.model = build_model(draft_cfg, device=device, target=target)
        self.device = self.model.device
        self.params = self.model.init(seed) if params is None else params
        self.state = self.model.init_decode_state(batch, self.state_len)
        self.graphs = StepGraphs(self.device)
        # tokens of the committed history already fed into the draft cache
        self.consumed = np.zeros(batch, np.int64)
        self._len_before = np.zeros(batch, np.int64)
        self._last_K = 0
        self._donors: dict[str, tuple[dict, int]] = {}
        self._cost_model = None

    def cost_per_token_s(self) -> float:
        """One draft decode step on the roofline (memory-bound), from the
        cost channel the target's admission prices with."""
        if self._cost_model is None:
            from .scheduler import CostModelAdmission

            self._cost_model = CostModelAdmission(self.cfg, self.batch, self.state_len,
                                                  lib=self.model.lib)
        return self._cost_model.step_seconds()

    # -- the target's lifecycle, mirrored ---------------------------------------

    def on_chunk(self, rid, seg, n_real) -> None:
        """Advance this request's draft donor by the SAME padded chunk the
        target prefilled."""
        if rid not in self._donors:
            self._donors[rid] = (self.model.init_decode_state(1, self.state_len), 0)
        donor, fill = self._donors[rid]
        run_prefill_chunk(self.graphs, self.model, self.params, donor,
                          np.asarray(seg, np.int64), fill, int(n_real))
        self._donors[rid] = (donor, fill + int(n_real))

    def on_graft(self, rid, slot, history) -> None:
        donor, fill = self._donors.pop(rid)
        self.model.insert_slot(self.state, donor, slot)
        # the target's first sampled token is in `history` but not yet fed
        # to the draft: the next propose round catches it up
        self.consumed[slot] = fill

    def on_commit(self, slot, m) -> None:
        """After a verify round accepting m drafts: the draft rows are right
        through the old history and the first min(m, K-1) drafts it fed while
        proposing (draft K itself was proposed, never fed)."""
        self.consumed[slot] = self._len_before[slot] + min(int(m), max(self._last_K - 1, 0))

    def on_finish(self, slot) -> None:
        self.consumed[slot] = 0

    # -- the draft rounds -------------------------------------------------------

    def _feed(self, tok_vec: np.ndarray, pos_vec: np.ndarray) -> np.ndarray:
        """One draft decode step; the greedy token per slot, (batch,)."""
        logits = run_model_step(self.graphs, "decode", self.model, self.params, self.state,
                                tok_vec[:, None], pos_vec)
        return logits[..., :self.cfg.vocab].argmax(-1).cpu().numpy().astype(np.int64)

    def propose(self, active, histories, k_vec, batch: int, K: int) -> np.ndarray:
        lens = np.zeros(batch, np.int64)
        for slot in active:
            lens[slot] = len(histories[slot])
            self._len_before[slot] = lens[slot]
        self._last_K = K
        # phase 1: catch up to the committed history (all but its last
        # token); caught-up slots re-feed their newest fed token at its own
        # row — an idempotent rewrite, logits discarded
        lag = max((int(lens[s]) - 1 - int(self.consumed[s]) for s in active), default=0)
        for _ in range(max(lag, 0)):
            toks = np.zeros(batch, np.int64)
            pos = np.maximum(self.consumed - 1, 0)
            for slot in active:
                c = int(self.consumed[slot])
                if c < lens[slot] - 1:
                    toks[slot] = histories[slot][c]
                    pos[slot] = c
                    self.consumed[slot] = c + 1
                elif c > 0:
                    toks[slot] = histories[slot][c - 1]
                    pos[slot] = c - 1
            self._feed(toks, pos)
        # phase 2: K greedy draft steps from each slot's pending token
        drafts = np.zeros((batch, K), np.int64)
        cur = np.zeros(batch, np.int64)
        pos = np.maximum(self.consumed - 1, 0)
        for slot in active:
            cur[slot] = histories[slot][-1]
            pos[slot] = lens[slot] - 1
        for i in range(K):
            cur = self._feed(cur, pos)
            pos = pos + 1
            drafts[:, i] = cur
        return drafts


def build_drafter(spec_cfg: SpeculationConfig, target_cfg, *, batch: int, state_len: int,
                  seed: int = 0, device: torch.device | str = "cuda",
                  target: str | None = None, params: dict | None = None):
    """The drafter ``spec_cfg`` names; a draft model is built on ``device``
    through the ``target`` library, as the engine's own model, with
    ``params`` (None: ``init(seed)``)."""
    if spec_cfg.drafter == "ngram":
        return NGramDrafter(max_ngram=spec_cfg.max_ngram)
    if spec_cfg.drafter == "draft_model":
        if not spec_cfg.draft_arch:
            raise ValueError("drafter='draft_model' needs draft_arch "
                             "(a configs/registry.py name)")
        from repro_torch.configs import get_config

        draft_cfg = get_config(spec_cfg.draft_arch)
        if target_cfg.vocab != draft_cfg.vocab:
            # reduced() test configs shrink the vocabulary: mirror the
            # reduction so registry pairs serve in full and reduced runs
            draft_cfg = draft_cfg.reduced()
        return DraftModelDrafter(draft_cfg, target_cfg, batch=batch, state_len=state_len,
                                 seed=seed, device=device, target=target, params=params)
    raise ValueError(f"unknown drafter {spec_cfg.drafter!r}")


__all__ = [
    "DraftModelDrafter",
    "NGramDrafter",
    "SpeculationConfig",
    "SpeculationPolicy",
    "accept_span",
    "build_drafter",
    "upd_verify_defaults",
]
