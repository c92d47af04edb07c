"""Token data pipeline (mirrors ``repro/data/pipeline.py``): synthetic stream
+ memmap-backed dataset, per-host sharding, background prefetch, and
resumable state (the step counter lives in the checkpoint manifest, so a
restart replays from the exact batch).

Batches are int32 numpy arrays drawn with
``np.random.default_rng(SeedSequence([seed, step, shard]))``, as in the
reference, so the two produce bit-identical batches. The copy to the device
is the training loop's (on its own thread), never the prefetch thread's.

Straggler surface: ``Prefetcher`` decouples host data work from the device
step; the StepWatchdog in launch/train.py reads the queue depth to tell a
data-starved step from a compute-slow one.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class DataState:
    step: int = 0
    epoch: int = 0

    def as_dict(self):
        return {"step": self.step, "epoch": self.epoch}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d.get("step", 0)), epoch=int(d.get("epoch", 0)))


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


class SyntheticTokens:
    """Deterministic synthetic LM stream: Zipf-ish marginal + shift labels.
    Deterministic in (seed, step, shard), so restart-safe by construction."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 shard: int = 0, n_shards: int = 1):
        if batch % n_shards:
            raise ValueError(f"batch {batch} does not split over {n_shards} shards")
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.shard, self.n_shards = seed, shard, n_shards

    def batch_at(self, step: int) -> dict:
        rng = _rng(self.seed, step, self.shard)
        b = self.batch // self.n_shards
        # Zipf-like marginal: heavier low ids (realistic token histogram)
        u = rng.random((b, self.seq + 1))
        toks = np.minimum((self.vocab * u ** 2.5).astype(np.int64),
                          self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapTokens:
    """Flat binary token file (uint16/uint32) -> random crops, host-sharded."""

    def __init__(self, path: str | Path, batch: int, seq: int, *,
                 dtype: str = "uint16", seed: int = 0, shard: int = 0,
                 n_shards: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.batch, self.seq = batch, seq
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        if len(self.data) <= seq + 1:
            raise ValueError(f"dataset of {len(self.data)} tokens is shorter than one "
                             f"sequence of {seq + 1}")

    def batch_at(self, step: int) -> dict:
        rng = _rng(self.seed, step, self.shard)
        b = self.batch // self.n_shards
        starts = rng.integers(0, len(self.data) - self.seq - 1, size=b)
        rows = np.stack([np.asarray(self.data[s:s + self.seq + 1])
                         for s in starts]).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Background thread keeping ``depth`` batches ready, in step order from
    ``state.step``; ``get`` advances ``state.step`` past the batch it
    returns, and raises where the source raised. ``stop`` ends the thread
    and joins it."""

    def __init__(self, source, state: DataState, depth: int = 2):
        self.source = source
        self.state = state
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_step = state.step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = (self._next_step, self.source.batch_at(self._next_step))
            except Exception as exc:      # handed to get(), which raises it
                item = (self._next_step, exc)
            self._next_step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return

    def get(self) -> dict:
        step, batch = self.q.get()
        if isinstance(batch, Exception):
            raise RuntimeError(f"data source failed at step {step}") from batch
        self.state.step = step + 1
        return batch

    @property
    def depth(self) -> int:
        return self.q.qsize()

    def stop(self):
        self._stop.set()
        self._thread.join(10.0)
